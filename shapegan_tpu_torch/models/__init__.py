"""The network zoo (ported so far: :class:`~shapegan_tpu_torch.models.sdf_net.SDFNet`
and :class:`~shapegan_tpu_torch.models.progressive_gan.ProgressiveDiscriminator`)."""

LATENT_CODES_FILENAME = "sdf_net_latent_codes"
