"""Models: UNet, VAE, CLIP text encoder, the weight bridge and the bundle."""
