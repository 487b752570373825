"""Plot rendering for runs: heatmaps, distributions, scatters, comparisons.

File naming and figure layout follow the reference ``plot_run.py`` so a
user switching frameworks finds the same artefacts:
``{method}_{score}_heatmap.{ext}`` seaborn clustermaps with NaN masked
orange and the custom species-boundary colormap (ref plot_run.py:49-150),
``{method}_{score}_dist.{ext}`` histogram+KDE+rug (ref plot_run.py:153-215),
``{method}_{query_cov,tANI}_scatter.{ext}`` jointplots coloured by query
length (ref plot_run.py:218-299), and the multi-run scatter/difference
grids with marginal histograms (ref plot_run.py:389-588). Layout
constants (figure size clamps, axes rectangles, width/height ratios) are
shared with the reference for visual parity; the code is this package's
own.
"""

from __future__ import annotations

import logging
import warnings
from math import ceil, log, nan, sqrt
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import pandas as pd
import seaborn as sns
from matplotlib import cm, colormaps, colors
from matplotlib.colors import LinearSegmentedColormap

from pyani_plus_tpu_torch import GRAPHICS_FORMATS
from pyani_plus_tpu_torch.db import Database, Run

ORANGE = (0.934, 0.422, 0)
GREY = (0.7, 0.7, 0.7)
DULL_BLUE = (0.137, 0.412, 0.737)
WHITE = (1.0, 1.0, 1.0)
DULL_RED = (0.659, 0.216, 0.231)

# Species-boundary colormap: grey <80%, blue 80-95%, white at the 95%
# species boundary, red to 100% (ref plot_run.py:49-72).
for _name, _segments in (
    (
        "spbnd_BuRd",
        (
            (0.00, GREY),
            (0.80, GREY),
            (0.80, DULL_BLUE),
            (0.95, WHITE),
            (1.00, DULL_RED),
        ),
    ),
    ("BuRd", ((0.0, DULL_BLUE), (0.5, WHITE), (1.0, DULL_RED))),
):
    if _name not in colormaps:
        colormaps.register(LinearSegmentedColormap.from_list(_name, _segments))

# Axis limits applied per score when drawing distributions; scores not
# listed here (e.g. query_cov) are left on matplotlib's auto limits,
# mirroring the reference's behaviour (ref plot_run.py:181-192).
_DIST_XLIMITS = {
    "hadamard": (0, 1.01),
    "coverage": (0, 1.01),
    "tANI": (0, 5.01),
    "identity": (0.80, 1.01),
}

_HIST_FILL = "#A6C8E0"
_RUG_BLUE = "#2678B2"


def plot_heatmap(  # noqa: PLR0913
    matrix: pd.DataFrame,
    outdir: Path,
    name: str,
    method: str,
    color_scheme: str,
    formats: tuple[str, ...] = GRAPHICS_FORMATS,
    na_fill: float = 0,
) -> int:
    """Seaborn clustermap of the matrix; TSV export uses dendrogram order.

    Figure size tracks the genome count between an aesthetic minimum of
    8 and a renderer-safe maximum of 120 inches, shrinking fonts once
    the cap is hit (ref plot_run.py:92-97).
    """
    side = min(max(8.0, matrix.shape[0] * 1.1), 120.0)
    if side >= 120.0:  # pragma: no cover - thousands of genomes
        sns.set_context("notebook", font_scale=120.0 / (matrix.shape[0] * 1.1))

    with warnings.catch_warnings():
        # Symmetric-matrix and fastcluster advisory warnings are expected
        warnings.simplefilter("ignore")
        grid = sns.clustermap(
            matrix.fillna(na_fill),
            mask=matrix.isna(),
            cmap=colormaps[color_scheme].with_extremes(bad=ORANGE),
            vmin=-5 if name == "tANI" and na_fill else 0,
            vmax=5 if name == "tANI" else 1,
            figsize=(side, side),
            linewidths=0.25,
        )
    # Park the colorbar over the row dendrogram's footprint so it cannot
    # overlap the clustermap body (ref plot_run.py:127-137).
    rows_box = grid.ax_row_dendrogram.get_position()
    cols_box = grid.ax_col_dendrogram.get_position()
    grid.ax_cbar.set_position(
        (rows_box.xmin, cols_box.ymin, min(0.05, rows_box.width), cols_box.height)
    )

    leaf_order = grid.dendrogram_row.reordered_ind
    for ext in formats:
        target = outdir / f"{method}_{name}_heatmap.{ext}"
        if ext == "tsv":
            matrix.iloc[leaf_order, leaf_order].to_csv(target, sep="\t")
        else:
            grid.savefig(target)
    plt.close()
    return len(formats)


def plot_distribution(
    values,
    outdir: Path,
    name: str,
    method: str,
    formats: tuple[str, ...] = GRAPHICS_FORMATS,
) -> int:
    """Histogram + KDE + rug of one score (ref plot_run.py:153-215)."""
    values = [v for v in values if v is not None and v == v]  # drop None/NaN
    figure, (ax_hist, ax_kde) = plt.subplots(1, 2, figsize=(15, 5))
    figure.suptitle(f"{name} distribution")
    sns.histplot(
        values,
        ax=ax_hist,
        stat="count",
        element="step",
        color=_HIST_FILL,
        edgecolor=_HIST_FILL,
    )
    ax_hist.set_ylim(ymin=0)
    sns.kdeplot(values, ax=ax_kde, warn_singular=False)
    limits = _DIST_XLIMITS.get(name)
    if limits:
        lo, hi = limits
        ax_hist.set_xlim(lo, hi)
        ax_kde.set_xlim(lo, hi)
        # The rug plot ignores axis limits, so clip its data instead
        values = [v for v in values if lo <= v <= hi]
    # Drawn below the axis (negative height + clip_on) so low-density
    # regions stay visible; alpha reveals the density.
    sns.rugplot(
        values, ax=ax_kde, color=_RUG_BLUE, height=-0.025, clip_on=False, alpha=0.1
    )
    figure.tight_layout(rect=(0, 0.03, 1, 0.95))
    for ext in formats:
        if ext != "tsv":
            figure.savefig(outdir / f"{method}_{name}_dist.{ext}")
    plt.close()
    return len(formats)


def plot_scatter(
    logger: logging.Logger,
    run: Run,
    outdir: Path,
    formats: tuple[str, ...] = GRAPHICS_FORMATS,
) -> int:
    """Query-coverage and tANI vs identity jointplots (ref plot_run.py:218-299)."""
    method = run.configuration.method
    query_length = dict(
        run._db.conn.execute(  # noqa: SLF001
            "SELECT genome_hash, length FROM genomes"
        ).fetchall()
    )
    comparisons = run.comparisons()
    for y_caption in ("Query coverage", "tANI"):
        points = []
        total = 0
        for comp in comparisons:
            total += 1
            identity, coverage = comp["identity"], comp["cov_query"]
            if identity is None or coverage is None:
                continue
            if y_caption == "tANI":
                if not identity * coverage:
                    continue
                y = -log(identity * coverage)
            else:
                y = coverage
            points.append((identity, y, query_length.get(comp["query_hash"], 0)))
        if not points:
            logger.warning(
                "No valid identity, %s values from %s run", y_caption, method
            )
            return 0
        logger.info(
            "Plotting %d/%d %s vs identity %s comparisons",
            len(points),
            total,
            y_caption,
            method,
        )
        xs, ys, cs = (list(column) for column in zip(*points))
        grid = sns.jointplot(
            x=xs,
            y=ys,
            kind="scatter",
            joint_kws={"s": 2, "c": cs, "color": None},
        )
        grid.set_axis_labels(xlabel="Percent identity (ANI)", ylabel=y_caption)
        # Make room on the right for the query-length colorbar
        plt.subplots_adjust(left=0.2, right=0.8, top=0.8, bottom=0.2)
        plt.colorbar(
            cm.ScalarMappable(norm=colors.Normalize(min(cs), max(cs))),
            cax=grid.fig.add_axes([0.85, 0.25, 0.05, 0.4]),
            label="Query length (bp)",
        )
        stem = "query_cov" if y_caption == "Query coverage" else y_caption
        for ext in formats:
            target = outdir / f"{method}_{stem}_scatter.{ext}"
            if ext == "tsv":
                with target.open("w") as handle:
                    handle.write(f"#identity\t{stem}\tquery_length\n")
                    handle.writelines(
                        f"{x}\t{y}\t{c}\n" for x, y, c in points
                    )
            else:
                grid.savefig(target)
        plt.close()
    return len(formats)


def plot_single_run(
    logger: logging.Logger,
    run: Run,
    outdir: Path,
    label: str = "stem",
    formats: tuple[str, ...] = GRAPHICS_FORMATS,
) -> int:
    """All plots for one run: 2 scatters + 4 scores x (dist, heatmap)."""
    method = run.configuration.method
    done = plot_scatter(logger, run, outdir, formats)
    scores_and_color_schemes = [
        ("identity", "spbnd_BuRd", 0),
        ("query_cov", "BuRd", 0),
        ("hadamard", "viridis", 0),
        ("tANI", "viridis_r", -5),  # must follow hadamard
    ]
    matrix = None
    for name, color_scheme, na_fill in scores_and_color_schemes:
        if name == "identity":
            matrix = run.identities
        elif name == "query_cov":
            matrix = run.cov_query
        elif name == "hadamard":
            matrix = run.hadamard
        if name == "tANI":
            # Reuses the relabelled Hadamard matrix from the prior pass
            matrix = matrix.map(lambda x: -log(x) if x else nan, na_action="ignore")
        else:
            matrix = run.relabelled_matrix(matrix, label)
        nulls = int(matrix.isnull().sum().sum())
        n = len(matrix)
        if nulls == n**2:
            logger.warning("Cannot plot %s as all NA", name)
            continue
        if nulls:
            logger.warning(
                "%s matrix contains %d nulls (out of %d²=%d %s comparisons)",
                name,
                nulls,
                n,
                n**2,
                method,
            )
        done += plot_distribution(
            matrix.values.flatten(), outdir, name, method, formats
        )
        done += plot_heatmap(
            matrix, outdir, name, method, color_scheme, formats, na_fill
        )
    return done


def _comparison_grid(vs_count: int, plots_per_row: int, plots_per_col: int):
    """One figure + the scatter/marginal-histogram axes grid.

    Geometry per ref plot_run.py:418-493: each comparison gets a
    notional 5x5 scatter with a 1x5 y-histogram on its right and a 1-
    unit spacer between comparison columns; one row of x-histograms of
    the base run's values sits on top. All scatters share x (and the
    caller may share y).
    """
    fig = plt.figure(figsize=(7 * plots_per_row - 1, 1 + 5 * plots_per_col))
    width_ratios = [5, 1] + [1, 5, 1] * (plots_per_row - 1)
    height_ratios = [1] + [5] * plots_per_col
    gs = fig.add_gridspec(
        1 + plots_per_col,
        3 * plots_per_row - 1,
        width_ratios=width_ratios,
        height_ratios=height_ratios,
        left=0.15 / plots_per_row,
        right=1 - 0.15 / plots_per_row,
        bottom=0.15 / plots_per_col,
        top=1 - 0.05 / plots_per_col,
        wspace=0.05,
        hspace=0.05,
    )
    return fig, gs


def plot_run_comparison(  # noqa: PLR0913, PLR0915
    logger: logging.Logger,
    db: Database,
    outdir: Path,
    run_ids: list[int],
    field: str = "identity",
    formats: tuple[str, ...] = GRAPHICS_FORMATS,
    hist_bins: int = 30,
    columns: int = 0,
) -> int:
    """Scatter + difference grids comparing a base run to other runs.

    Follows the reference plot_run_comp layout (ref plot_run.py:389-588):
    for each mode in (scatter, diff) a grid of one panel per other run
    against the base run — red y=x (scatter) or y=0 (diff) guide line,
    per-panel y-histogram margins, a top row of x-histograms of the
    base run's values — plus one TSV of the common values per run pair.
    Outputs ``{method}_{field}_{base}_vs_{other}.tsv`` and
    ``{method}_{field}_{base}_{mode}_vs_others.{ext}``.
    """
    if len(run_ids) < 2:
        msg = "Need a base run and at least one other run to compare"
        raise ValueError(msg)
    base = db.load_run(run_ids[0])
    other_ids = run_ids[1:]
    method = base.configuration.method
    base_values = {
        (comp["query_hash"], comp["subject_hash"]): comp["identity"]
        for comp in base.comparisons()
        if comp["identity"] is not None
    }
    logger.info(
        "Plotting %d runs against %s run %d which has %d comparisons",
        len(other_ids),
        method,
        base.run_id,
        len(base_values),
    )

    vs_count = len(other_ids)
    plots_per_row = columns if columns > 0 else ceil(sqrt(vs_count))
    plots_per_col = ceil(vs_count / plots_per_row)

    done = 0
    for mode in ("scatter", "diff"):
        fig, gs = _comparison_grid(vs_count, plots_per_row, plots_per_col)
        scatters: dict[int, plt.Axes] = {}
        margins: dict[int, plt.Axes] = {}
        for panel in range(vs_count):
            grid_row = 1 + panel // plots_per_row
            grid_col = 3 * (panel % plots_per_row)
            if panel == 0:
                ax = fig.add_subplot(gs[grid_row, grid_col])
            else:
                ax = fig.add_subplot(
                    gs[grid_row, grid_col],
                    sharex=scatters[0],
                    sharey=scatters[0] if mode == "scatter" else None,
                )
            scatters[panel] = ax
            margin = fig.add_subplot(gs[grid_row, grid_col + 1], sharey=ax)
            margin.tick_params(axis="y", labelleft=False)
            margin.get_xaxis().set_visible(False)
            margin.spines[["top", "right", "bottom"]].set_visible(False)
            margins[panel] = margin
            if grid_row == plots_per_col:
                ax.set_xlabel(base.name)
            else:
                ax.tick_params(axis="x", labelbottom=False)

        # Top margin: the base run's overall value distribution, repeated
        # over each comparison column.
        for column in range(min(vs_count, plots_per_row)):
            top = fig.add_subplot(gs[0, column * 3], sharex=scatters[0])
            top.spines[["left", "top", "right"]].set_visible(False)
            top.get_yaxis().set_visible(False)
            top.tick_params(axis="x", labelbottom=False)
            top.hist(base_values.values(), bins=hist_bins, orientation="vertical")

        for panel, other_id in enumerate(other_ids):
            other = db.load_run(other_id)
            common = {
                pair: comp["identity"]
                for comp in other.comparisons()
                if comp["identity"] is not None
                and (pair := (comp["query_hash"], comp["subject_hash"]))
                in base_values
            }
            if not common:
                msg = (
                    f"Runs {base.run_id} and {other_id} have no comparisons"
                    " in common"
                )
                raise SystemExit(msg)
            xs = [base_values[pair] for pair in common]
            ys = list(common.values())
            if mode == "scatter":
                logger.info(
                    "Plotting %s run %d vs %s run %d, with %d comparisons in common",
                    other.configuration.method,
                    other_id,
                    method,
                    base.run_id,
                    len(common),
                )
                if "tsv" in formats:
                    target = (
                        outdir
                        / f"{method}_{field}_{base.run_id}_vs_{other_id}.tsv"
                    )
                    with target.open("w") as handle:
                        handle.write(f"#{base.name}\t{other.name}\n")
                        handle.writelines(
                            f"{x}\t{y}\n" for x, y in zip(xs, ys)
                        )

            ax = scatters[panel]
            ax.spines[["top", "right"]].set_visible(False)
            if mode == "diff":
                ys = [y - x for x, y in zip(xs, ys)]
                ax.plot([min(xs), max(xs)], [0, 0], "-", color="r")
            else:
                shared = [max(min(xs), min(ys)), min(max(xs), max(ys))]
                ax.plot(shared, shared, "-", color="r")
            ax.scatter(x=xs, y=ys, s=2, alpha=0.2)
            ax.set_ylabel(other.name)
            margins[panel].hist(ys, bins=hist_bins, orientation="horizontal")

        for ext in formats:
            if ext != "tsv":
                fig.savefig(
                    outdir
                    / f"{method}_{field}_{base.run_id}_{mode}_vs_others.{ext}"
                )
                done += 1
        plt.close(fig)
    return done
