"""Training pipelines (ported so far: the hybrid GAN's generation path)."""
