"""Runnable tours of the port (`python -m qcss_tpu_torch.examples.demo`)."""
