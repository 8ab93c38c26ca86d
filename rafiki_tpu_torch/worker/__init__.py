"""Worker processes of the port: the inference worker
(``python -m rafiki_tpu_torch.worker.inference --config ...``)."""
