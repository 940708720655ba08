"""The pipeline's stages: base training, Reflow training, the benchmark."""
