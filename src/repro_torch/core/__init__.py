"""Hardware description and execution plans (the port's copies of what it
needs from ``repro.core``: ``cluster``, ``strategy``)."""
