"""Data parallelism over ranks (`dist.py`), the counterpart of
`advmix_tpu/parallel/`."""
