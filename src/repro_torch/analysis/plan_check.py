"""Static serving checks: the port's copy of the GALV08x subset of
``repro.analysis.plan_check``.

CODE      SLUG                              SEVERITY
080   serve-page-indivisible            error
081   serve-pool-hbm-overcommit         error
082   serve-slots-pages-insufficient    error

``check_serve`` verifies a paged-cache serving geometry before any device
memory is touched.  Weight bytes come from the port's own parameter
definitions (``models.common.count_params``), counted by the JAX check's
rule (no final norm).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.configs.registry import ModelConfig
from repro_torch.core.cluster import ClusterSpec

ERROR = "error"
WARNING = "warning"

#: code -> (slug, severity, generic fix hint)
CATALOG: dict[str, tuple[str, str, str]] = {
    "GALV080": ("serve-page-indivisible", ERROR,
                "pick page_size dividing max_context — a partial tail page "
                "would silently truncate the advertised context window"),
    "GALV081": ("serve-pool-hbm-overcommit", ERROR,
                "shrink num_pages/num_slots, raise tp, or lower max_context "
                "— the kv page pool plus the tp-sharded weights exceed HBM"),
    "GALV082": ("serve-slots-pages-insufficient", ERROR,
                "grow num_pages: each decode slot needs at least one real "
                "page (page 0 is the reserved null page)"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    code: str
    message: str
    where: str = ""
    severity: str = ""           # filled from CATALOG when empty

    def __post_init__(self):
        if self.code not in CATALOG:
            raise ValueError(f"unknown diagnostic code {self.code!r}")
        if not self.severity:
            object.__setattr__(self, "severity", CATALOG[self.code][1])

    @property
    def slug(self) -> str:
        return CATALOG[self.code][0]

    @property
    def hint(self) -> str:
        return CATALOG[self.code][2]

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.code} {self.slug} ({self.severity}){loc}: {self.message}"


@dataclasses.dataclass
class PlanReport:
    diagnostics: list[Diagnostic] = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> list[str]:
        return [d.code for d in self.diagnostics]

    def error_codes(self) -> list[str]:
        return [d.code for d in self.errors]

    def format_table(self) -> str:
        """Human-readable diagnostic table."""
        if not self.diagnostics:
            return "plan verification: OK (0 diagnostics)"
        rows = [("CODE", "SEVERITY", "WHERE", "MESSAGE")]
        for d in self.diagnostics:
            rows.append((d.code, d.severity, d.where or "-", d.message))
        widths = [max(len(r[i]) for r in rows) for i in range(3)]
        lines = []
        for i, r in enumerate(rows):
            lines.append("  ".join(c.ljust(w) for c, w in zip(r[:3], widths))
                         + "  " + r[3])
            if i > 0:
                d = self.diagnostics[i - 1]
                lines.append(" " * (sum(widths) + 4) + f"  hint: {d.hint}")
        status = "FAIL" if self.errors else "OK"
        lines.append(f"plan verification: {status} "
                     f"({len(self.errors)} error(s), "
                     f"{len(self.warnings)} warning(s))")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Paged-cache geometry to verify.  ``num_pages=None`` means full
    provisioning (``1 + num_slots * ceil(max_context / page_size)``);
    ``tp`` is the degree the weights are sharded over; ``bytes_per_elem``
    the kv/weight element width (bf16 by default)."""

    num_slots: int
    page_size: int
    max_context: int
    num_pages: Optional[int] = None
    tp: int = 1
    bytes_per_elem: float = 2.0

    def resolved_num_pages(self) -> int:
        if self.num_pages is not None:
            return self.num_pages
        return 1 + self.num_slots * math.ceil(
            max(self.max_context, 1) / max(self.page_size, 1))


def weight_params(cfg: ModelConfig) -> int:
    """Parameter count from the port's own model definitions, by the JAX
    check's rule (``profile_model(cfg, ...).total_params()``): the embedding
    and head, and each layer's weights with its two norm scales, but not the
    final norm's scale."""
    from repro_torch.models.common import count_params
    from repro_torch.models.transformer import DenseTransformerLM

    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet (dense only)")
    defs = DenseTransformerLM(cfg, device="cpu").param_defs()
    return count_params({k: v for k, v in defs.items() if k != "final_norm"})


def check_serve(spec: ServeSpec, cluster: ClusterSpec,
                cfg: ModelConfig) -> PlanReport:
    """Page size divides the context window (GALV080), pool + tp-sharded
    weights fit HBM (GALV081), and the pool holds at least one real page per
    decode slot (GALV082)."""
    out = PlanReport()
    diag = out.diagnostics.append
    pages = spec.resolved_num_pages()

    if spec.page_size < 1 or spec.max_context % spec.page_size != 0:
        diag(Diagnostic("GALV080", f"page_size {spec.page_size} does not "
                        f"divide max_context {spec.max_context}",
                        where="cache"))

    if pages - 1 < spec.num_slots:
        diag(Diagnostic("GALV082", f"{pages} pages (incl. the null page) "
                        f"cannot give {spec.num_slots} slots one page each",
                        where="cache"))

    tp = max(spec.tp, 1)
    weight_bytes = spec.bytes_per_elem * weight_params(cfg) / tp
    pool_bytes = (2.0 * spec.bytes_per_elem * cfg.num_layers * pages
                  * spec.page_size * cfg.num_kv_heads
                  * cfg.resolved_head_dim) / tp
    need = weight_bytes + pool_bytes
    if need > cluster.hbm_bytes:
        diag(Diagnostic(
            "GALV081",
            f"kv pool/tp {pool_bytes / 1e9:.2f} GB + weights/tp "
            f"{weight_bytes / 1e9:.2f} GB = {need / 1e9:.2f} GB exceeds "
            f"{cluster.hbm_bytes / 1e9:.2f} GB HBM", where="cache"))
    return out
