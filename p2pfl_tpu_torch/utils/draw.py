"""Topology rendering: ``topology.png`` next to a scenario's metrics.

The counterpart of ``p2pfl_tpu/utils/draw.py``; best effort: a no-op
without matplotlib and networkx (the card's machine has neither).
"""

from __future__ import annotations

import pathlib

from p2pfl_tpu_torch.topology.topology import Topology

_ROLE_COLORS = {
    "trainer": "#6baed6",
    "aggregator": "#74c476",
    "server": "#fd8d3c",
    "proxy": "#9e9ac8",
    "idle": "#bdbdbd",
}


def draw_topology(topology: Topology, path: str | pathlib.Path,
                  roles: list[str] | None = None) -> pathlib.Path | None:
    """Render the federation graph to PNG. Returns None (and does
    nothing) if matplotlib or networkx is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import networkx as nx
    except Exception:
        return None
    g = nx.from_numpy_array(topology.adjacency.astype(int))
    colors = ([_ROLE_COLORS.get(r, "#bdbdbd") for r in roles] if roles
              else "#6baed6")
    fig, ax = plt.subplots(figsize=(6, 6))
    pos = nx.circular_layout(g)
    nx.draw_networkx(g, pos=pos, ax=ax, node_color=colors, node_size=600,
                     font_size=8, edge_color="#999999")
    ax.set_title(f"{topology.kind} (n={topology.n})")
    ax.axis("off")
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
