"""The ``pyani-plus-tpu-torch`` command line."""
