"""Host-side data (counterpart of ``pointcloudlib_tpu/data``; numpy only)."""
