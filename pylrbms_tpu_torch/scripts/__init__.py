"""Entry scripts of the port (run with ``python -m pylrbms_tpu_torch.scripts.<name>``)."""
