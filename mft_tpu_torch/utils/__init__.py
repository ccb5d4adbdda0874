"""Utilities of the port (a copy of what it needs of ``mft_tpu/utils``)."""
