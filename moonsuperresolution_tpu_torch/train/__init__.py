"""Training of the GauGAN family: the trainer and the loop."""
