"""Subpackage of cvsteer_tpu_torch (see the package docstring)."""
