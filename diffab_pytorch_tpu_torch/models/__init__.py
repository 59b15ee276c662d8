"""Context encoders, IPA, the denoiser and the DiffAb model."""
