"""Data providers (counterpart of ``gordo_tpu/dataset/data_provider``)."""
