"""Utilities (counterpart of ``pointcloudlib_tpu/utils``)."""
