"""The process-group mesh of the port (counterpart of
:mod:`shapegan_tpu.parallel`): :mod:`.mesh`, and the work that spawned
ranks run for the sharding tests and the smoke test, :mod:`.rank_checks`."""
