"""Seeds of the parts of a run, derived from ``--seed`` and a name, so that
any whole number (negative or past 64 bits too) gives each part its own
stream, and the same seed the same inputs."""

import hashlib


def derive(seed: int, name: str) -> int:
    """A seed in [0, 2**62) for the part ``name`` of the run ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 2
