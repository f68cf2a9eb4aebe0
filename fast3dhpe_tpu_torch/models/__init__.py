"""Network modules of the port (CDRNet, ResNet encoder, decoder)."""
