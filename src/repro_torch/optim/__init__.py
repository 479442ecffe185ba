"""The optimizer and gradient compression (src/repro/optim/)."""
