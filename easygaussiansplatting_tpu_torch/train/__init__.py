"""Training: configuration, the single-camera step, Adam and density control."""
