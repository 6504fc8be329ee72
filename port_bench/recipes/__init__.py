"""Data recipes, one a file (``<recipe>.py``), named by a configuration's
``data.recipe``.  Each has ``points(cfg, rows, g, device)`` and
``targets(cfg, x, count, g)``, drawn on the device from the generator."""
