"""llama3.2-1b-long — the llama3.2-1b backbone tuned for 32k-token context:
same dims, longer rope base, ``long_context=True`` so the 32k train shape
runs.  The context-parallelism scenario config: at 32k the cp=1 activation
footprint per device exceeds the usual budgets, so the search engine must
reach for a cp>1 ring-attention plan (benchmarks/context_parallel.py).
[derived from hf:meta-llama/Llama-3.2-1B; unverified]"""
import dataclasses

from repro_torch.configs.llama3_2_1b import CONFIG as _BASE

CONFIG = dataclasses.replace(
    _BASE,
    name="llama3.2-1b-long",
    rope_theta=8_000_000.0,      # long-context rope base (32k window)
    long_context=True,
    source="derived from hf:meta-llama/Llama-3.2-1B; 32k variant, unverified",
)
