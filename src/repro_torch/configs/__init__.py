"""Model configurations: the port's own copy of the pure-data ``repro.configs``."""
