"""See portbench/__init__.py."""
