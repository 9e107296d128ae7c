"""The benchmark of ``recom_tpu_torch``, the PyTorch and CUDA port: a
harness driven by the files under this folder (README.md)."""
