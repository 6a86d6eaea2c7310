"""The LM substrate on one device: layers (with kernel K8) and the decoder."""
