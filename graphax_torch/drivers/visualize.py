"""Attention and diffusion figures (port of `graphax/drivers/visualize.py`,
the reference's `src/visualise_attention.py` and `src/post_analysis.py`).

- `draw_attention_graph`: a networkx drawing, edge widths and colours from
  the attention per edge (`visualise_attention.py:10-43`);
- `plot_image_diffusion`: pixel grids at t = 0 and t = T side by side
  (`post_analysis.py:17-60`);
- `animate_diffusion`: a GIF over a solve's frames
  (`post_analysis.py:62-122`);
- `plot_attention_heatmap`: the attention as a dense heatmap.

They take the port's `Graph` and tensors (or arrays) on any device, and
draw from host copies. matplotlib (the headless 'Agg' backend) and networkx
are imported inside the functions, as graphax does: nothing on a training
path imports them."""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(a) -> np.ndarray:
    """A host numpy copy of a tensor (any device) or array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _real_edges(graph, attention_per_edge):
    mask = _host(graph.edge_mask)
    return (_host(graph.row)[mask], _host(graph.col)[mask],
            _host(attention_per_edge)[mask])


def draw_attention_graph(graph, attention_per_edge, positions=None,
                         out_path="attention_graph.png", max_nodes=200):
    """networkx spring-layout drawing, edge width proportional to the
    attention, of the first ``max_nodes`` nodes."""
    import networkx as nx

    plt = _plt()
    row, col, att = _real_edges(graph, attention_per_edge)
    keep = (row < max_nodes) & (col < max_nodes)
    g = nx.DiGraph()
    g.add_nodes_from(range(min(graph.num_nodes, max_nodes)))
    for r, c, a in zip(row[keep], col[keep], att[keep]):
        g.add_edge(int(r), int(c), weight=float(a))
    pos = positions or nx.spring_layout(g, seed=0)
    weights = [g[u][v]["weight"] for u, v in g.edges()]
    wmax = max(weights) if weights else 1.0
    fig, ax = plt.subplots(figsize=(8, 8))
    nx.draw_networkx(g, pos, ax=ax, node_size=30, with_labels=False,
                     width=[3.0 * w / wmax for w in weights],
                     edge_color=weights, edge_cmap=plt.cm.viridis,
                     arrows=False)
    ax.set_axis_off()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_image_diffusion(x0, xT, height, width, out_path="diffusion.png",
                         num_images=4):
    """Pixel grids before and after diffusion (`post_analysis.py:17-60`)."""
    plt = _plt()
    x0 = _host(x0).reshape(-1, height, width)
    xT = _host(xT).reshape(-1, height, width)
    n = min(num_images, x0.shape[0])
    fig, axes = plt.subplots(2, n, figsize=(2.2 * n, 4.6))
    if n == 1:
        axes = axes.reshape(2, 1)
    for i in range(n):
        axes[0, i].imshow(x0[i], cmap="gray")
        axes[0, i].set_title("t = 0")
        axes[1, i].imshow(xT[i], cmap="gray")
        axes[1, i].set_title("t = T")
        for ax in (axes[0, i], axes[1, i]):
            ax.set_axis_off()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def animate_diffusion(frames, height, width, out_path="diffusion.gif",
                      interval_ms=200):
    """A GIF over a solve's frames (a sequence of ``[height * width]``
    states)."""
    plt = _plt()
    from matplotlib.animation import FuncAnimation, PillowWriter

    frames = np.stack([_host(f) for f in frames]).reshape(
        len(frames), height, width)
    fig, ax = plt.subplots()
    im = ax.imshow(frames[0], cmap="gray")
    ax.set_axis_off()

    def update(i):
        im.set_data(frames[i])
        ax.set_title(f"frame {i}")
        return [im]

    anim = FuncAnimation(fig, update, frames=len(frames),
                         interval=interval_ms)
    anim.save(out_path, writer=PillowWriter(fps=max(1000 // interval_ms, 1)))
    plt.close(fig)
    return out_path


def plot_attention_heatmap(graph, attention_per_edge,
                           out_path="attention_heatmap.png", max_nodes=300):
    """The attention of the first ``max_nodes`` nodes as a dense
    heatmap."""
    plt = _plt()
    n = min(graph.num_nodes, max_nodes)
    dense = np.zeros((n, n))
    row, col, att = _real_edges(graph, attention_per_edge)
    keep = (row < n) & (col < n)
    np.add.at(dense, (row[keep], col[keep]), att[keep])
    fig, ax = plt.subplots(figsize=(7, 6))
    imref = ax.imshow(dense, cmap="magma")
    fig.colorbar(imref, ax=ax)
    ax.set_title("attention")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
