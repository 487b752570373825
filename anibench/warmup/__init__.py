"""Warm-ups, one module a method (``warmup/<method>.py``): ``warm(...)``
runs the program on the cell's own shapes before the window, so that
every library is built and loaded and the card's context is up."""
