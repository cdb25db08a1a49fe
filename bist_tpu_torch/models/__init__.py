"""The BiST model: transformer layers, reasoning layers, generator, full model."""
