"""Text-to-image pipeline: conditioning, DDIM sampling, VAE decode."""
