"""What the entries share: configuration and traffic files read into a
package's ``PipelineConfig`` (the port's, or the reference's frozen
copy), their rehearsal sizes, an optional span, and results moved to
the host."""

from __future__ import annotations

import contextlib


def sizes(config: dict, traffic: dict, rehearse: bool):
    """(config, traffic) with their ``rehearse`` overrides applied when
    rehearsing on the CPU."""
    if not rehearse:
        return config, traffic

    def merged(base, over):
        out = dict(base)
        for k, v in over.items():
            out[k] = merged(base.get(k, {}), v) if isinstance(v, dict) else v
        return out

    return (merged(config, config.get("rehearse", {})),
            merged(traffic, traffic.get("rehearse", {})))


def pipeline_config(cfgmod, config: dict, traffic: dict):
    """``cfgmod.PipelineConfig`` from the configuration's ``sift`` and
    ``match`` settings and the traffic's ``ransac`` and ``pipeline``."""
    sift = {k: tuple(v) if isinstance(v, list) else v
            for k, v in config.get("sift", {}).items()}
    return cfgmod.PipelineConfig(
        sift=cfgmod.SiftConfig(**sift),
        match=cfgmod.MatchConfig(**config.get("match", {})),
        ransac=cfgmod.RansacConfig(**traffic.get("ransac", {})),
        **traffic.get("pipeline", {}))


def span(spans, name):
    """``spans.span(name)``, or nothing in an untraced run."""
    return contextlib.nullcontext() if spans is None else spans.span(name)


def to_host(x):
    """Tensors (in a dict, list or tuple) to numpy on the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x
