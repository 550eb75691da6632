"""nn.Modules for the CLIP text towers, the SDXL UNet and the VAE decoder."""
