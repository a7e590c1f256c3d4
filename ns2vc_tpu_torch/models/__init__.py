"""Models of the port: encoders, UNet denoiser, diffusion core, Vocos."""
