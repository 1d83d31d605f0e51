"""Measured per-(site, layer, exec_path) latency table.

The port of `repro.obs.latency`. Every break-even knob of the control loop
is otherwise priced from cost-model constants (energy figures,
`RAGGED_BREAK_EVEN_SKIP`); this module produces the measured replacement:

* :class:`LatencyTable` — per-(site, layer, exec_path) latency statistics
  (count / mean / p50 / p95 seconds), saved/loaded as the reference's
  versioned `obs_latency_table` JSON, so either package loads the other's;
* :func:`build_from_spans` — builds a table from obs spans that carry
  ``site`` / ``exec_path`` tags (the probe emits them; any span source works);
* :func:`probe_latency_table` — measures each registered site's wall-clock
  per viable execution path (the basic-mode product as the baseline, then
  the masked walk, `kernel`, and the compacted walk, `ragged`, when gk >= 2;
  `dense` and `compact` on the reference serve's "jnp" tier)
  on the reference's synthetic delta stream matched to the site's MEASURED
  skip rate. On the card each path is one `reuse_linear` call captured as a
  CUDA graph over static input and cache tensors and replayed with the two
  inputs copied in turn; with `graphs=False` (the serve's `--eager`) and on
  the CPU the same call runs directly.

`python -m repro_torch.tune.fit --latency-table` and the online controller
(`repro_torch.control.Controller`) hand the loaded table to the harvest
model (`FitConfig.latency`), which then prices break-even hit rates and
exec-path pins from these measured numbers.

Stacked sites are probed once at layer=None (every layer shares the dispatch
geometry), and `LatencyTable.stat` falls back layer→None on lookup.

Provenance: rows measured on the card carry ``backend="cuda",
interpret=False`` (`table_provenance` reads "compiled"); rows from the plain
versions on the CPU carry ``backend="torch", interpret=True``: they are the
oracle tier, not the substrate that serves, and must not price a serve on
the card. The tag fields are the reference's (`TAG_FIELDS`), so both
packages keep each other's tags on load.
"""

from __future__ import annotations

import dataclasses
import gc
import json
from typing import Any, Iterable

import numpy as np
import torch

LATENCY_TABLE_SCHEMA_VERSION = 1
LATENCY_TABLE_KIND = "obs_latency_table"

# The baseline "execution path" of the basic-mode (ReuseOFF) evaluation: it
# names the whole quantized product the reuse paths are priced against.
BASIC_PATH = "basic"


class LatencyTableError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class LatencyStat:
    count: int
    mean_s: float
    p50_s: float
    p95_s: float

    @staticmethod
    def from_samples(samples: Iterable[float]) -> "LatencyStat":
        a = np.asarray(list(samples), np.float64)
        return LatencyStat(
            count=int(a.size),
            mean_s=float(a.mean()) if a.size else 0.0,
            p50_s=float(np.quantile(a, 0.5)) if a.size else 0.0,
            p95_s=float(np.quantile(a, 0.95)) if a.size else 0.0,
        )


_Key = tuple[str, Any, str]  # (site, layer|None, exec_path)

# Provenance fields kept on every row (the reference's names): which
# substrate produced the measurement. The port stamps `backend` and
# `interpret`; a reference table's jax versions ride along on load.
TAG_FIELDS = ("backend", "interpret", "jax_version", "jaxlib_version")


class LatencyTable:
    """Measured dispatch latency per (site, layer, exec_path)."""

    def __init__(self):
        self._samples: dict[_Key, list[float]] = {}
        self._tags: dict[_Key, dict[str, Any]] = {}
        self.meta: dict[str, Any] = {}

    def record(self, site: str, layer: int | None, exec_path: str,
               seconds: float, *, tags: dict[str, Any] | None = None) -> None:
        key = (site, layer, exec_path)
        self._samples.setdefault(key, []).append(float(seconds))
        if tags:
            self._tags[key] = {k: tags[k] for k in TAG_FIELDS if k in tags}

    def stat(self, site: str, exec_path: str, *,
             layer: int | None = None) -> LatencyStat | None:
        """Measured stats for one (site, layer, exec_path); a layer-specific
        lookup falls back to the site-wide (layer=None) row."""
        samples = self._samples.get((site, layer, exec_path))
        if samples is None and layer is not None:
            samples = self._samples.get((site, None, exec_path))
        if not samples:
            return None
        return LatencyStat.from_samples(samples)

    def paths_for(self, site: str, *,
                  layer: int | None = None) -> dict[str, LatencyStat]:
        """{exec_path: stat} of every measured path for one site (layer rows
        preferred, site-wide rows filling the gaps)."""
        out: dict[str, LatencyStat] = {}
        for (s, lyr, path), samples in self._samples.items():
            if s != site or not samples:
                continue
            if lyr is None and path not in out:
                out[path] = LatencyStat.from_samples(samples)
            elif layer is not None and lyr == layer:
                out[path] = LatencyStat.from_samples(samples)
        return out

    def rows(self) -> list[dict[str, Any]]:
        out = []
        for (site, layer, path), samples in sorted(
            self._samples.items(),
            key=lambda kv: (kv[0][0], -1 if kv[0][1] is None else kv[0][1],
                            kv[0][2]),
        ):
            stat = LatencyStat.from_samples(samples)
            out.append({
                "site": site, "layer": layer, "exec_path": path,
                **dataclasses.asdict(stat),
                **self._tags.get((site, layer, path), {}),
            })
        return out

    def __len__(self) -> int:
        return len(self._samples)

    def summary_lines(self) -> list[str]:
        lines = [f"LatencyTable: {len(self)} (site, layer, exec_path) rows"]
        for r in self.rows():
            where = r["site"] + (f"@{r['layer']}" if r["layer"] is not None
                                 else "")
            lines.append(
                f"  {where:24s} {r['exec_path']:8s} n={r['count']:3d} "
                f"mean={r['mean_s'] * 1e6:9.1f}us p50={r['p50_s'] * 1e6:9.1f}us "
                f"p95={r['p95_s'] * 1e6:9.1f}us"
            )
        return lines

    # ------------------------------------------------------------ save/load

    def save(self, path: str, *, meta: dict[str, Any] | None = None) -> None:
        doc = {
            "schema_version": LATENCY_TABLE_SCHEMA_VERSION,
            "kind": LATENCY_TABLE_KIND,
            "meta": {**self.meta, **(meta or {})},
            "rows": self.rows(),
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")


def load_latency_table(path: str) -> LatencyTable:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("kind") != LATENCY_TABLE_KIND:
        raise LatencyTableError(f"{path}: not a {LATENCY_TABLE_KIND} document")
    ver = doc.get("schema_version")
    if ver != LATENCY_TABLE_SCHEMA_VERSION:
        raise LatencyTableError(
            f"{path}: schema_version {ver} != supported "
            f"{LATENCY_TABLE_SCHEMA_VERSION}")
    table = LatencyTable()
    table.meta = dict(doc.get("meta", {}))
    for r in doc.get("rows", []):
        # mean-weighted reconstruction: one synthetic sample per recorded
        # stat keeps save→load→stat round trips exact for mean, and p50/p95
        # collapse onto it (percentile detail lives in the saving process)
        key = (r["site"], r.get("layer"), r["exec_path"])
        table._samples[key] = [float(r["mean_s"])] * max(int(r["count"]), 1)
        tags = {k: r[k] for k in TAG_FIELDS if k in r}
        if tags:
            table._tags[key] = tags
    return table


def table_provenance(table: LatencyTable) -> str:
    """Which substrate produced a table's measurements.

    "compiled"  — every tagged row (or the meta) says interpret=False: the
                  card's kernels, or the reference's compiled backends
    "interpret" — every tagged row says interpret=True: the port's plain
                  versions on the CPU, or interpret-mode Pallas
    "mixed"     — both kinds of rows in one table
    "unknown"   — no backend tags anywhere

    `fit --latency-table` and `serve --latency-table` warn (and journal) on
    anything but "compiled".
    """
    flags: set[bool] = set()
    for key in table._samples:
        tags = table._tags.get(key)
        if tags is not None and "interpret" in tags:
            flags.add(bool(tags["interpret"]))
    if not flags and "interpret" in table.meta:
        flags.add(bool(table.meta["interpret"]))
    if not flags:
        return "unknown"
    if flags == {False}:
        return "compiled"
    if flags == {True}:
        return "interpret"
    return "mixed"


def build_from_spans(span_rows: Iterable[dict[str, Any]]) -> LatencyTable:
    """A LatencyTable from obs spans tagged with site/exec_path (layer
    optional) — the probe's spans, or any instrumented source."""
    table = LatencyTable()
    for row in span_rows:
        site = row.get("site")
        path = row.get("exec_path")
        if site is None or path is None:
            continue
        table.record(site, row.get("layer"), path, row["dur_s"], tags=row)
    return table


# -------------------------------------------------------------- the prober

def _path_tag(device: torch.device) -> dict[str, Any]:
    """Substrate provenance of a probed path: every path on the card runs
    the serve's own code (the Hopper kernels, the basic-mode product); on
    the CPU every path runs the plain versions, the oracle tier."""
    if device.type == "cuda":
        return {"backend": "cuda", "interpret": False}
    return {"backend": "torch", "interpret": True}


def _viable_paths(spec, impl: str) -> list[str]:
    """Execution paths measurable for one site: the masked walk plus — when
    the K extent compacts (gk >= 2) — the compacted tier; "dense" and
    "compact" on the "jnp" tier, "kernel" and "ragged" on the others."""
    gk = -(-spec.in_features // spec.block_k)
    paths = ["dense", "compact"] if impl == "jnp" else ["kernel", "ragged"]
    return paths if gk >= 2 else paths[:1]


@torch.no_grad()
def probe_latency_table(
    engine,
    batch: int,
    *,
    skip_rates: dict[str, float] | None = None,
    iters: int = 5,
    warmup: int = 2,
    seed: int = 0,
    device="cuda",
    graphs: bool | None = None,
    caches: dict | None = None,
) -> LatencyTable:
    """Measure every registered site's wall-clock per viable path.

    For each site: the reference's synthetic activation pair whose delta
    skips ~the site's measured tile-skip rate (`skip_rates`, e.g. from a
    live SensorReport; default 0.5) and its f32 weight, drawn with the same
    numpy calls in the same order, so a seed gives the reference's skip
    pattern. Then one `reuse_linear` call per path — the basic mode
    (recorded as exec_path "basic"), then each reuse path — on a static
    input and a fresh site cache: `warmup` calls, then `iters` timed ones,
    the two inputs copied in turn. Each timed call is a `site_probe` span of
    host clock around a synchronize; on the card the span also carries the
    call's device time between CUDA events (`device_s`). The table is built
    from those spans, so a probe run joins the event stream like any other
    measurement.

    Beyond the reference: `device` (default the card; "cpu" runs the plain
    versions, without a card "cuda" raises), `graphs` (default: on the
    card) and `caches` (a dict filled with each path's final site cache
    under (site, path)). Each site's weight and graphs are freed before the
    next site.
    """
    from repro_torch.core.reuse_cache import init_site_cache
    from repro_torch.core.reuse_linear import reuse_linear
    from repro_torch.obs import trace
    from repro_torch.serve.compiled_step import CompiledStep

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_latency_table: device cuda but no CUDA "
                           "device is available; pass device='cpu' to run "
                           "the plain PyTorch versions")
    graphs = device.type == "cuda" if graphs is None else graphs
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
    on_card = device.type == "cuda"
    tag = _path_tag(device)
    was_enabled = trace.is_enabled()
    if not was_enabled:
        trace.enable()
    probe_spans: list[dict[str, Any]] = []
    rng = np.random.default_rng(seed)
    try:
        for name, spec in engine.sites.items():
            skip = float((skip_rates or {}).get(name, 0.5))
            skip = min(max(skip, 0.0), 1.0)
            gk = -(-spec.in_features // spec.block_k)
            # Two activation sets whose mutual delta leaves ~skip of the
            # K-blocks untouched: alternating them gives every timed call
            # the same measured-regime tile occupancy.
            x_a = rng.standard_normal(
                (batch, spec.in_features)).astype(np.float32)
            x_b = x_a.copy()
            live_blocks = [j for j in range(gk) if rng.random() >= skip] \
                or [0]
            for j in live_blocks:
                lo = j * spec.block_k
                hi = min(lo + spec.block_k, spec.in_features)
                x_b[:, lo:hi] += rng.standard_normal(
                    (batch, hi - lo)).astype(np.float32)
            w = torch.from_numpy(rng.standard_normal(
                (spec.in_features, spec.out_features)).astype(np.float32)
                * 0.05).to(device)
            xs = [torch.from_numpy(x_a).to(device),
                  torch.from_numpy(x_b).to(device)]

            budget = spec.max_active_k
            if budget is None:
                occupancy = max(len(live_blocks) / gk, 1.0 / gk)
                budget = max(1, min(gk, int(np.ceil(gk * occupancy * 1.25))))

            for path in [BASIC_PATH] + _viable_paths(spec, engine.impl):
                if path == BASIC_PATH:
                    pspec, mode = spec, "basic"
                else:
                    pspec = dataclasses.replace(
                        spec, exec_path=path,
                        max_active_k=(budget if path in ("ragged", "compact")
                                      else None))
                    mode = "reuse"
                cache = init_site_cache(pspec, batch,
                                        engine.policy.resolve(name),
                                        device=device)
                x = torch.empty_like(xs[0])

                def fn(_spec=pspec, _mode=mode, _cache=cache, _x=x):
                    return reuse_linear(_x, w, None, _cache, _spec,
                                        mode=_mode, impl=engine.impl)[0]

                # the compiled step of one call: its first call runs `fn` and
                # captures it, every later one replays (or, without graphs,
                # runs it directly)
                step = CompiledStep(None, None, {"len": x.new_zeros(())},
                                    batch=batch, graphs=graphs)
                for i in range(max(warmup, 1)):
                    x.copy_(xs[i % 2])
                    out = step.decode_call(fn)
                trace.synchronize(out)
                n0 = len(trace.spans())
                ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                      if on_card else None)
                for i in range(iters):
                    with trace.span("site_probe", site=name, layer=None,
                                    exec_path=path, skip_rate=skip,
                                    **tag) as sp:
                        if ev:
                            ev[0].record()
                        x.copy_(xs[i % 2])
                        out = step.decode_call(fn)
                        if ev:
                            ev[1].record()
                            ev[1].synchronize()
                            sp.tag(device_s=ev[0].elapsed_time(ev[1]) / 1e3)
                        sp.sync(out)
                probe_spans.extend(trace.spans()[n0:])
                if caches is not None:
                    caches[(name, path)] = cache
                del step, fn, out, x
            del w, xs
            if on_card:
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        if not was_enabled:
            trace.disable()

    table = build_from_spans(probe_spans)
    table.meta = {
        "source": "probe_latency_table",
        "impl": engine.impl,
        "batch": batch,
        "iters": iters,
        "graphs": graphs,
        **tag,
        "torch_version": torch.__version__,
        "device_name": (torch.cuda.get_device_name(device) if on_card
                        else "cpu"),
    }
    return table
