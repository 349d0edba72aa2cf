"""The benchmark of ``pylrbms_tpu_torch`` on an NVIDIA H100 (see ``run.py``)."""
