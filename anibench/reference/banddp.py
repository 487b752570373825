"""The banded affine-gap DP of ANIm's gap fills and extensions, for many
tasks at once, in plain PyTorch.

The recurrences, scores and tie rules are those of pyANI-plus-TPU's host
oracle (``ops/extend_host._band_dp``): states M (diagonal), D (vertical)
and I (horizontal), each carrying (score, similarity errors, character
non-identities, gap columns); match 3, mismatch -7, gap open -13 and
extend -7; M wins ties over D over I; an I run takes the latest source
of the row's running maximum. Anchored tasks (gap fills) end at (m, n)
on the band centred at ``i * n // m``; free-end tasks (extensions)
follow the unit diagonal and keep the best cell, a larger ``i + j``
winning ties, and give up ``stop_rows`` rows after their last gain.

Every task has its own band; all advance one row together, and tasks
that have ended are dropped once they are half of those left. The I
state's running maximum is taken over ``key * 256 + column``, so that
the latest column wins a tie on any device.
"""

from __future__ import annotations

import numpy as np
import torch

MATCH = 3
MISMATCH = -7
OPEN = -13
EXTEND = -7
NEG = -(10**9)
_HALF = NEG // 2
_TIE = 256  # more columns than any band in a batch has


def _pick(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Max of two stacked (score, e, n, g) states; the first wins ties."""
    return torch.where(y[0] > x[0], y, x)


def band_dp(
    tasks: list[tuple[np.ndarray, np.ndarray, int]],
    *,
    free_end: bool,
    stop_rows: int = 0,
    device: torch.device | str = "cpu",
) -> list[tuple[int, int, int, int, int, int]]:
    """(i, j, score, errors, nonid, gap columns) of each (a, b, band)
    task with ``a.size`` and ``b.size`` both above 0."""
    if not tasks:
        return []
    width = max(2 * band + 1 for _, _, band in tasks)
    if width >= _TIE:
        msg = f"a band of {(width - 1) // 2} is wider than this DP takes"
        raise ValueError(msg)
    with torch.inference_mode():
        return _rows(tasks, free_end, stop_rows, torch.device(device), width)


def _rows(tasks, free_end: bool, stop_rows: int, device: torch.device, lanes: int):  # noqa: C901, PLR0915
    nb = len(tasks)
    m_np = np.array([a.size for a, _, _ in tasks], dtype=np.int64)
    n_np = np.array([b.size for _, b, _ in tasks], dtype=np.int64)
    if (m_np == 0).any() or (n_np == 0).any():
        raise ValueError("band_dp takes tasks with both sequences non-empty")
    m_max, n_max = int(m_np.max()), int(n_np.max())
    a_pad = np.full((nb, m_max), 255, dtype=np.uint8)
    b_pad = np.full((nb, n_max), 254, dtype=np.uint8)
    for t, (a, b, _) in enumerate(tasks):
        a_pad[t, : a.size] = a
        b_pad[t, : b.size] = b

    def col(values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, dtype=np.int64), device=device)[:, None]

    offs = torch.arange(lanes, dtype=torch.int64, device=device)
    dead = torch.tensor([NEG, 0, 0, 0], dtype=torch.int64, device=device).view(4, 1, 1)
    task = {
        "idx": torch.arange(nb, device=device),
        "m": col(m_np),
        "n": col(n_np),
        "band": col([band for _, _, band in tasks]),
        "a": torch.as_tensor(a_pad, device=device),
        "b": torch.as_tensor(b_pad, device=device),
        "best": torch.zeros((nb, 6), dtype=torch.int64, device=device),
        "since": torch.zeros(nb, dtype=torch.int64, device=device),
        "dead": torch.zeros(nb, dtype=torch.bool, device=device),
    }
    final = torch.zeros((nb, 6), dtype=torch.int64, device=device)
    in_band = offs <= 2 * task["band"]

    def centre(i: int) -> torch.Tensor:
        if free_end:
            return torch.full_like(task["m"], i)
        return (i * task["n"]) // task["m"]

    # row 0: the origin in M; I holds the horizontal runs of row 0
    js0 = offs - task["band"]
    M = dead.repeat(1, nb, lanes)
    M[0] = torch.where(in_band & (js0 == 0), 0, NEG)
    D = dead.repeat(1, nb, lanes)
    i_ok = in_band & (js0 >= 1) & (js0 <= task["n"])
    I = torch.stack([torch.where(i_ok, OPEN + EXTEND * (js0 - 1), NEG), *[torch.where(i_ok, js0, 0)] * 3])

    def update_best(i: int, cell: torch.Tensor, js_base: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        best = task["best"]
        cs = cell[0]
        rmax = cs.max(dim=1).values
        kmax = torch.where(cs == rmax[:, None], offs, -1).max(dim=1).values
        jb = kmax + js_base[:, 0]
        upd = active & ((rmax > best[:, 2]) | ((rmax == best[:, 2]) & (i + jb > best[:, 0] + best[:, 1])))
        picked = cell[1:].gather(2, kmax.view(1, -1, 1).expand(3, -1, 1))[:, :, 0]
        new = torch.stack([torch.full_like(jb, i), jb, rmax, *picked], dim=1)
        best.copy_(torch.where(upd[:, None], new, best))
        return upd

    if free_end:
        update_best(0, _pick(_pick(M, D), I), -task["band"], torch.ones(nb, dtype=torch.bool, device=device))

    def shifted(state: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        ok = (index >= 0) & (index < lanes)
        got = state.gather(2, index.clamp(0, lanes - 1).expand(state.shape[0], -1, -1))
        return torch.where(ok, got, dead)

    for i in range(1, m_max + 1):
        active = (task["m"][:, 0] >= i) & ~task["dead"]
        n_active = int(active.sum())
        if n_active == 0:
            break
        if n_active <= active.numel() // 2:
            gone = ~active
            if free_end:
                final[task["idx"][gone]] = task["best"][gone]
            keep = active.nonzero()[:, 0]
            task = {key: val[keep] for key, val in task.items()}
            M, D, I = M[:, keep], D[:, keep], I[:, keep]
            active = active[keep]
            in_band = offs <= 2 * task["band"]
        ci = centre(i)
        shift = ci - centre(i - 1)
        js = offs + ci - task["band"]
        valid = in_band & (js >= 0) & (js <= task["n"])
        valid1 = valid & (js >= 1)
        ac = task["a"][:, i - 1 : i].long()
        bc = task["b"].gather(1, (js - 1).clamp(0, task["b"].shape[1] - 1)).long()

        # M: the diagonal predecessor, best of M >= D >= I
        diag = shifted(_pick(_pick(M, D), I), offs + shift - 1)
        same = bc == ac
        sub_ok = same & (ac < 4) & (bc < 4)
        score = torch.where(sub_ok, MATCH, MISMATCH)
        live = valid1 & (diag[0] > _HALF)
        nM = torch.where(
            live,
            torch.stack([diag[0] + score, diag[1] + (~sub_ok), diag[2] + (~same), diag[3]]),
            dead,
        )

        # D: the vertical predecessor; open from max(M, I) (tie M),
        # continue from D on ties
        up_o = shifted(_pick(M, I), offs + shift)
        up_d = shifted(D, offs + shift)
        open_s = torch.where(up_o[0] > _HALF, up_o[0] + OPEN, NEG)
        cont_s = torch.where(up_d[0] > _HALF, up_d[0] + EXTEND, NEG)
        take_cont = cont_s >= open_s
        d = torch.where(take_cont, up_d, up_o)
        d = torch.stack([torch.where(take_cont, cont_s, open_s), d[1] + 1, d[2] + 1, d[3] + 1])
        nD = torch.where(~valid | (d[0] <= _HALF), dead, d)

        # I: the latest running-maximum source of the row's open keys
        base = _pick(nM, nD)
        key = torch.where(base[0] > _HALF, base[0] + OPEN - EXTEND * (offs + 1), NEG)
        run = torch.cummax(key * _TIE + offs, dim=1).values
        src = run - torch.div(run, _TIE, rounding_mode="floor") * _TIE
        run_max = torch.div(run - src, _TIE, rounding_mode="floor")
        left_max = torch.cat([torch.full_like(run_max[:, :1], NEG), run_max[:, :-1]], dim=1)
        left_src = torch.cat([torch.zeros_like(src[:, :1]), src[:, :-1]], dim=1)
        ok_i = valid1 & (left_max > _HALF)
        pay = base[1:].gather(2, left_src.expand(3, -1, -1)) + (offs - left_src)
        nI = torch.where(ok_i, torch.cat([(left_max + EXTEND * offs)[None], pay]), dead)

        M, D, I = nM, nD, nI
        if free_end:
            upd = update_best(i, _pick(_pick(M, D), I), ci - task["band"], active)
            since = task["since"]
            since.copy_(torch.where(active, torch.where(upd, 0, since + 1), since))
            if stop_rows > 0:
                task["dead"] |= active & (since >= stop_rows)
        else:
            ends = task["m"][:, 0] == i
            if bool(ends.any()):
                cell = _pick(_pick(M, D), I).gather(2, task["band"].view(1, -1, 1).expand(4, -1, 1))[:, :, 0]
                m_t, n_t = task["m"][:, 0], task["n"][:, 0]
                row = torch.stack([m_t, n_t, *cell], dim=1)
                worst = torch.maximum(m_t, n_t)
                missed = torch.stack([m_t, n_t, torch.full_like(m_t, NEG), worst, worst, (m_t - n_t).abs()], dim=1)
                row = torch.where((cell[0] > _HALF)[:, None], row, missed)
                final[task["idx"][ends]] = row[ends]

    if free_end:
        final[task["idx"]] = task["best"]
    return [tuple(row) for row in final.cpu().tolist()]
