"""See the package docstring of :mod:`eagle_tpu_torch`."""
