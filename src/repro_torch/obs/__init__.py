"""Runtime telemetry (the port's part of ``repro.obs``): so far only
``drift``, the step-time drift rule that ``plan_check`` (GALV070) and the
train launcher read.  Metrics, spans and the run sink are a later slice."""
