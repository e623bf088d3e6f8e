"""The program's entry points that cells drive, one module each: a
configuration names its entry (``"entry"``), and the module's
``build(config, state, device, input_size)`` returns the callable that the
cell's kind of mix calls."""
