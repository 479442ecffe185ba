"""The large-model stack's layers (src/repro/nn): functional modules over
nested dicts of tensors with the reference's keys."""
