"""Operations and bytes of one layer from its shapes: one module per
layer kind, ``<op>.py``, each with ``ops(layer, batch)``,
``mac_ops(layer, batch)`` and ``nbytes(layer, batch)``."""
