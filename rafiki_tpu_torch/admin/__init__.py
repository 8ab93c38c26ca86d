"""The control plane: admin, REST app, services manager, device probe
(the port's counterpart of ``rafiki_tpu/admin``)."""
