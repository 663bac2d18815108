from gordo_tpu_torch.anomaly.diff import DiffBasedAnomalyDetector  # noqa: F401
