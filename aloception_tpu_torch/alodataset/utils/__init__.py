"""Helpers of the datasets (counterpart of ``aloception_tpu/alodataset/utils``)."""
