"""Static checks (the serving subset of ``repro.analysis.plan_check``)."""
