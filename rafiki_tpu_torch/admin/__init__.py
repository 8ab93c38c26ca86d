"""The control plane: admin, REST app, services manager, device probe,
process identity and the workdir doctor (the port's counterpart of
``rafiki_tpu/admin``)."""
