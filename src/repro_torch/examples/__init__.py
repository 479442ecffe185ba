"""The paper's example drivers, on the port: ``python -m
repro_torch.examples.<name>`` (quickstart, qat_finetune, eclipse_orbit,
onboard_serving, train_driver). Each runs on the card unless given
``--device cpu``."""
