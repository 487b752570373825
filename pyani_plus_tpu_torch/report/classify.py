"""Clique-based genome classification over ANI results.

Output-compatible with the reference ``classify.py`` (cited per
function). The clique *discovery order* is part of the output contract
(the TSV rows appear in discovery order), so the edge-removal schedule
— weakest edge first, recurse when the graph disconnects — is
reproduced exactly; the code itself is this package's own.

Overview: build an undirected graph whose nodes are genomes and whose
edges aggregate the two asymmetric comparison directions (coverage agg
default min, score agg default mean), dropping edges with missing
values or coverage <= cov_min (ref classify.py:64-105); take cliques of
the initial connected components (ref classify.py:114-132); then
repeatedly remove the lowest-scoring edge, recursing into components
whenever the graph disconnects, recording each clique with the edge
score that formed it (ref classify.py:135-189); dedupe by member set
(ref classify.py:192-207); write ``{method}_classify.tsv`` rounded to
7 dp (ref classify.py:433-464) and the stacked classify figure
(ref classify.py:236-431).
"""

from __future__ import annotations

import logging
import math
from collections import defaultdict
from itertools import combinations
from pathlib import Path
from typing import Callable, NamedTuple

import networkx as nx
import numpy as np
import pandas as pd

from pyani_plus_tpu_torch.db import Database

AGG_FUNCS: dict[str, Callable] = {
    "min": min,
    "max": max,
    "mean": np.mean,
}

MIN_COVERAGE = 0.50  # ref classify.py:49


class CliqueInfo(NamedTuple):
    """Graph structure summary (ref classify.py:54-61)."""

    n_nodes: int
    max_cov: float | None
    min_score: float | None
    max_score: float | None
    members: list


def construct_graph(
    cov_matrix: pd.DataFrame,
    score_matrix: pd.DataFrame,
    coverage_agg: Callable,
    score_agg: Callable,
    min_coverage: float,
) -> nx.Graph:
    """Build the genome graph from coverage + score matrices (ref classify.py:64-105).

    Each unordered pair contributes one candidate edge whose attributes
    aggregate the two comparison directions. The aggregation sees the
    directional values as an ordered two-element list — order matters
    for ``min``/``max`` when one direction is NaN (Python's min/max are
    first-wins under unordered comparisons), and the reference's
    ordering is kept.
    """
    graph = nx.Graph()
    genomes = cov_matrix.columns
    graph.add_nodes_from(genomes)
    # The vectorised path below indexes both matrices positionally, so the
    # two frames must share axis ordering; align score_matrix by label
    # first (a no-op when they already match, which is the normal case).
    if not (
        cov_matrix.index.equals(score_matrix.index)
        and cov_matrix.columns.equals(score_matrix.columns)
    ):
        score_matrix = score_matrix.reindex(
            index=cov_matrix.index, columns=cov_matrix.columns
        )
    fast = _vectorised_agg(cov_matrix, coverage_agg), _vectorised_agg(
        score_matrix, score_agg
    )
    if fast[0] is not None and fast[1] is not None:
        # Vectorised path for the stock aggregators: at N=1000 the
        # 499,500-pair Python loop of .at lookups costs ~40 s; the
        # whole-matrix formulation is milliseconds and reproduces the
        # loop's first-wins NaN semantics exactly (tested).
        coverage_m, score_m = fast
        i_idx, j_idx = np.triu_indices(len(genomes), k=1)
        cov_vals = coverage_m[i_idx, j_idx]
        score_vals = score_m[i_idx, j_idx]
        keep = (
            ~np.isnan(cov_vals)
            & ~np.isnan(score_vals)
            & (cov_vals > min_coverage)
        )
        names = np.asarray(genomes, dtype=object)
        graph.add_edges_from(
            (names[i], names[j], {"coverage": float(c), "score": float(s)})
            for i, j, c, s in zip(
                i_idx[keep], j_idx[keep], cov_vals[keep], score_vals[keep]
            )
        )
        return graph
    for genome1, genome2 in combinations(genomes, 2):
        # matrix[col][row]: direction (query=row, subject=col)
        directions = [(genome2, genome1), (genome1, genome2)]
        coverage = coverage_agg([cov_matrix.at[q, s] for q, s in directions])
        score = score_agg([score_matrix.at[q, s] for q, s in directions])
        if pd.isna(coverage) or pd.isna(score) or coverage <= min_coverage:
            continue
        graph.add_edge(genome1, genome2, coverage=coverage, score=score)
    return graph


def _vectorised_agg(matrix: pd.DataFrame, agg: Callable) -> np.ndarray | None:
    """Whole-matrix pairwise aggregation for the stock agg functions.

    For the unordered pair (g1, g2) at positions (i, j), the loop
    evaluates ``agg([M[j, i], M[i, j]])`` -- first direction (genome2,
    genome1). Python's min/max return the FIRST element when a
    comparison involves NaN (all comparisons False), so
    ``min([x, y]) == y if y < x else x`` -- the np.where forms below
    reproduce that exactly, NaNs included; np.mean propagates NaN.
    Returns None for a non-stock aggregator (generic loop handles it).
    """
    values = matrix.to_numpy(dtype=float)
    x = values.T  # x[i, j] = M[j, i], the first direction
    y = values
    with np.errstate(invalid="ignore"):
        if agg is min:
            return np.where(y < x, y, x)
        if agg is max:
            return np.where(y > x, y, x)
        if agg is np.mean:
            return (x + y) / 2.0
    return None


def is_clique(graph: nx.Graph) -> bool:
    """True if the (sub)graph is fully connected (ref classify.py:108-111)."""
    n_nodes = graph.number_of_nodes()
    return graph.number_of_edges() == n_nodes * (n_nodes - 1) / 2


def find_initial_cliques(graph: nx.Graph) -> list[tuple]:
    """Cliques among the initial connected components (ref classify.py:114-132).

    Components that are already cliques (before any edge removal) are
    recorded with the globally weakest edge score as their formation
    score.
    """
    scores = [attrs["score"] for _, _, attrs in graph.edges(data=True)]
    weakest = min(scores) if scores else None
    cliques: list[tuple] = []
    for component in nx.connected_components(graph):
        candidate = graph.subgraph(component).copy()
        if is_clique(candidate):
            cliques.append((candidate, weakest))
    return cliques


def find_cliques_recursively(
    graph: nx.Graph,
    min_score: float | None = None,
) -> list[tuple]:
    """Remove lowest-score edges, recursing on disconnection (ref classify.py:135-189).

    Mutates ``graph``. Records (clique_subgraph, formation_score) in
    discovery order: the current graph first if it is already a clique,
    then the cliques of each component (in ``nx.connected_components``
    order) after the weakest-edge removals disconnect it.
    """
    if graph.number_of_nodes() == 1:
        return [(graph, min_score)]
    found: list[tuple] = []
    if is_clique(graph):
        found.append((graph.copy(), min_score))
    # One pass over the edges sorted weakest-first (sorted once, as the
    # reference does — removals do not re-rank the remaining edges).
    for u, v, attrs in sorted(
        graph.edges(data=True), key=lambda edge: edge[2]["score"]
    ):
        min_score = attrs["score"]
        graph.remove_edge(u, v)
        parts = list(nx.connected_components(graph))
        if len(parts) > 1:
            for part in parts:
                found.extend(
                    find_cliques_recursively(
                        graph.subgraph(part).copy(), min_score=min_score
                    )
                )
            break
    return found


def get_unique_cliques(
    initial_cliques: list[tuple], recursive_cliques: list[tuple]
) -> list[tuple]:
    """Dedupe cliques by member set, keeping first occurrence (ref classify.py:192-207)."""
    first_seen: dict[frozenset, tuple] = {}
    for clique, formed_at in [*initial_cliques, *recursive_cliques]:
        first_seen.setdefault(frozenset(clique.nodes), (clique, formed_at))
    return list(first_seen.values())


def compute_classify_output(
    cliques: list, method: str, outdir: Path, column_map: dict
) -> tuple[list[CliqueInfo], pd.DataFrame]:
    """Write {method}_classify.tsv, 7 dp rounding (ref classify.py:433-464).

    Quirk preserved from the reference: both ``max_cov`` and
    ``max_score`` are the *minimum* edge attribute over the clique
    (the weakest link that holds the clique together).
    """
    rows = []
    for clique, formed_at in cliques:
        coverages = [attrs["coverage"] for _, _, attrs in clique.edges(data=True)]
        scores = [attrs["score"] for _, _, attrs in clique.edges(data=True)]
        rows.append(
            CliqueInfo(
                n_nodes=clique.number_of_nodes(),
                max_cov=min(coverages) if coverages else None,
                min_score=formed_at,
                max_score=min(scores) if scores else None,
                members=list(clique.nodes),
            )
        )
    table = pd.DataFrame(rows)
    table["members"] = table["members"].str.join(",")
    table = table.rename(columns=column_map)
    table.round(7).to_csv(outdir / f"{method}_classify.tsv", sep="\t", index=False)
    return rows, table


def genome_clique_ids(dataframe: pd.DataFrame, suffix: str) -> dict:
    """Map each genome to the clique row indices it belongs to (ref classify.py:210-224).

    Mutates ``dataframe`` like the reference: fills the singleton
    ``max_{suffix}`` holes (1.0 for identity, 0.0 for tANI) and splits
    the comma-joined members back into lists.
    """
    dataframe[f"max_{suffix}"] = dataframe[f"max_{suffix}"].fillna(
        1.0 if suffix == "identity" else 0.0
    )
    dataframe["members"] = dataframe["members"].str.split(",")
    memberships: dict = defaultdict(list)
    for idx, members in dataframe["members"].items():
        for genome in members:
            memberships[genome].append(idx)
    return memberships


def genome_positions(memberships: dict) -> dict:
    """Y-axis position per genome, ordered by clique membership (ref classify.py:227-233)."""
    ordered = sorted(memberships, key=memberships.__getitem__)
    return {genome: position for position, genome in enumerate(ordered)}


def plot_classify(  # noqa: PLR0913, PLR0915
    positions: dict,
    dataframe: pd.DataFrame,
    outdir: Path,
    method: str,
    score: str,
    vertical_line: float,
    formats: tuple[str, ...] = ("tsv", "png"),
) -> None:
    """Stacked classify figure (layout per ref classify.py:236-431).

    Four vertically stacked, x-sharing panels:
    1. genome counts in cliques vs as singletons across the score range;
    2. percentage of all genomes covered at each score;
    3. per-clique lifespan bars (hot-colormap rectangles; grey dashed
       lines for singletons) against the genome y-axis;
    4. a colorbar strip mapping formation score to the panel-3 colours.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm
    from matplotlib.colors import Normalize
    from matplotlib.patches import Rectangle

    num_genomes = len(positions)
    lows = dataframe[f"min_{score}"]
    highs = dataframe[f"max_{score}"]
    axis_floor = math.floor(lows.min() * 100) / 100

    # Figure geometry scales with the genome count (ref classify.py:254-278).
    fig_height = max(num_genomes * 0.15, 15)
    label_size = max(6, min(12, 300 // num_genomes))
    hspace = min(0.1, 10 / num_genomes)
    fig, (ax_count, ax_pct, ax_span, ax_cbar) = plt.subplots(
        4,
        1,
        figsize=(15, fig_height),
        gridspec_kw={
            "height_ratios": [0.7, 0.7, max(5, num_genomes * 0.1), 0.2],
            "hspace": hspace,
        },
        sharex=True,
    )
    fig.subplots_adjust(left=0.2, top=0.85, hspace=hspace)
    ax_count.tick_params(labelbottom=True)
    ax_pct.tick_params(labelbottom=True)

    norm = Normalize(vmin=axis_floor - 0.01, vmax=lows.max())
    colormap = cm.hot

    # Panels 1+2: how many genomes sit in cliques / as singletons at
    # each score level, counted over a fixed 99-bin grid up to 1.0.
    grid = np.linspace(axis_floor, 1.0, 100)[:-1]
    in_cliques = np.zeros_like(grid)
    as_singletons = np.zeros_like(grid)
    for _, row in dataframe.iterrows():
        alive = (grid >= row[f"min_{score}"]) & (grid <= row[f"max_{score}"])
        size = len(row["members"])
        if size > 1:
            in_cliques[alive] += size
        else:
            as_singletons[alive] += 1

    ax_count.plot(grid, in_cliques, color="blue", linewidth=2, label="Genomes in Cliques")
    ax_count.fill_between(grid, in_cliques, color="blue", alpha=0.3)
    ax_count.plot(
        grid,
        as_singletons,
        color="red",
        linewidth=2,
        linestyle="--",
        label="Singleton Genomes",
    )
    ax_count.set_ylabel("Number of \n Genomes", fontsize=10)
    ax_count.grid(visible=True, linestyle="--", linewidth=0.5, alpha=0.7)
    ax_count.legend()

    covered_pct = (in_cliques + as_singletons) / num_genomes * 100
    ax_pct.plot(grid, covered_pct, color="green", linewidth=2, label="% Genomes")
    ax_pct.fill_between(grid, covered_pct, color="green", alpha=0.3)
    ax_pct.set_ylabel("Percentage of \n All Genomes", fontsize=10)
    ax_pct.set_ylim(0, 100)
    ax_pct.grid(visible=True, linestyle="--", linewidth=0.5, alpha=0.9)
    ax_pct.legend()

    # Panel 3: lifespan of every clique across the score axis.
    for _, row in dataframe.iterrows():
        start, end = row[f"min_{score}"], row[f"max_{score}"]
        ys = [positions[genome] for genome in row["members"]]
        if len(row["members"]) == 1:
            ax_span.hlines(
                y=min(ys),
                xmin=start,
                xmax=end,
                colors="grey",
                linestyles="dashed",
                linewidth=1.5,
            )
        else:
            ax_span.add_patch(
                Rectangle(
                    (start, min(ys) - 0.4),
                    end - start,
                    max(ys) - min(ys) + 0.8,
                    linewidth=1,
                    edgecolor="black",
                    facecolor=colormap(norm(start)),
                    alpha=0.8,
                )
            )
    ax_span.set_xlabel(f"{score}")
    ax_span.set_ylabel("Genomes", fontsize=6)
    ax_span.set_yticks(range(num_genomes))
    ax_span.set_yticklabels(positions.keys(), fontsize=label_size)
    ax_span.yaxis.set_label_position("right")
    ax_span.yaxis.tick_right()
    ax_span.set_xlim(axis_floor - 0.01, highs.max())
    ax_span.set_ylim(-1, num_genomes)
    # The default 0.95 species boundary maps to -0.323 on the -tANI axis.
    threshold = vertical_line
    if vertical_line == 0.95 and score != "identity":  # noqa: PLR2004
        threshold = -0.323
    ax_span.axvline(x=threshold, color="red", linewidth=2, linestyle="--")
    ax_span.grid(visible=True, linestyle="--", linewidth=0.5, alpha=0.9)

    # Panel 4: a horizontal gradient strip as the colour legend.
    gradient = np.linspace(norm.vmin, norm.vmax, 512)
    ax_cbar.imshow(
        gradient[None, :],
        aspect="auto",
        cmap=colormap,
        norm=norm,
        extent=(norm.vmin, norm.vmax, 0, 1),
    )
    ax_cbar.set_xlim(norm.vmin, norm.vmax)
    ax_cbar.set_ylim(0, 1)
    ax_cbar.set_xlabel(f"Min {score}", fontsize=10)
    ax_cbar.xaxis.set_label_position("bottom")
    ax_cbar.set_yticks([])
    ax_cbar.tick_params(axis="x", labelsize=10, direction="out")

    for ext in formats:
        if ext != "tsv":
            fig.savefig(
                outdir / f"{method}_classify_plot.{ext}",
                format=ext,
                bbox_inches="tight",
            )
    plt.close(fig)


def classify_run(  # noqa: PLR0913
    logger: logging.Logger,
    db: Database,
    outdir: Path,
    *,
    run_id: int | None = None,
    mode: str = "identity",
    label: str = "stem",
    cov_min: float = MIN_COVERAGE,
    score_agg: str = "mean",
    cov_agg: str = "min",
    vertical_line: float = 0.95,
    plot: bool = True,
    formats: tuple[str, ...] = ("tsv", "png"),
) -> pd.DataFrame:
    """Run the full classify pipeline for a run (ref public_cli.py:1211-1355)."""
    run = db.load_run(run_id, check_complete=True)
    method = run.configuration.method

    if mode == "identity":
        matrix = run.identities
    elif mode == "tANI":
        tani = run.tani
        matrix = tani.where(tani.isna(), tani * -1)
    else:
        msg = f"Unknown classify mode {mode!r}"
        raise ValueError(msg)

    cov = run.cov_query
    score_matrix = run.relabelled_matrix(matrix, label)
    cov = run.relabelled_matrix(cov, label)

    complete_graph = construct_graph(
        cov, score_matrix, AGG_FUNCS[cov_agg], AGG_FUNCS[score_agg], cov_min
    )
    if len(list(nx.connected_components(complete_graph))) != 1:
        initial_cliques = find_initial_cliques(complete_graph)
    else:
        initial_cliques = []
    recursive_cliques = find_cliques_recursively(complete_graph)
    unique_cliques = get_unique_cliques(initial_cliques, recursive_cliques)

    suffix = "identity" if mode == "identity" else "-tANI"
    column_map = {"min_score": f"min_{suffix}", "max_score": f"max_{suffix}"}
    _clique_data, clique_df = compute_classify_output(
        unique_cliques, method, outdir, column_map
    )
    logger.info("Wrote classify output to %s", outdir)

    if plot:
        if set(clique_df["n_nodes"]) == {1}:
            logger.warning("All genomes are singletons. No plot can be generated.")
        elif len(run.genome_hashes) > 1:
            plot_df = clique_df.copy()
            memberships = genome_clique_ids(plot_df, suffix)
            plot_classify(
                genome_positions(memberships),
                plot_df,
                outdir,
                method,
                suffix,
                vertical_line,
                formats,
            )
    return clique_df
