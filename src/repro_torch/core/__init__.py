"""Hardware description (the port's copy of what it needs from ``repro.core``)."""
