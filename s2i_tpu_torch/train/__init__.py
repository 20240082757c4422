"""Training of the port: losses and the encoder distillation step."""
