"""Runners, one a file (``<kind>.py`` with a ``Runner``), named by a
mix's ``kind``."""
