"""Control-region resource-element-group (REG) layout for PCFICH/PHICH/PDCCH.

Host-side numpy, copied from the reference's `phch/regs.py` (the port
imports nothing of the reference package; a test holds the two equal).

Reference behavior: `lib/src/phy/phch/regs.c` — REG enumeration
(regs.c:733-760), per-symbol REG counts (regs_num_x_symbol, :636), REG RE
indices with CRS holes (regs_reg_init, :652), PCFICH placement
(regs_pcfich_init, :491), PHICH group assignment (regs_phich_init, :245),
PDCCH sub-block interleave + cell shift (regs_pdcch_init, :77).

All of this is static per cell configuration, so it runs on the host once and
yields flat RE index tables (into the (14*NRE) grid) consumed by device
gathers.  Normal CP / normal PHICH duration / FDD; extended variants follow.
"""

from __future__ import annotations

import functools

import numpy as np

from . import grid as grid_mod

PDCCH_PERM = np.array(
    [1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
     0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30],
    dtype=np.int64,
)
PHICH_NG = {"1/6": 1 / 6, "1/2": 0.5, "1": 1.0, "2": 2.0}


n_ctrl_symbols = grid_mod.n_ctrl_symbols


def _regs_per_symbol(sym: int, n_ports: int) -> int:
    if sym == 0:
        return 2
    if sym == 1:
        return 2 if n_ports == 4 else 3
    return 3  # sym 2, 3 (normal CP)


@functools.lru_cache(maxsize=None)
def reg_table(n_prb: int, cell_id: int, n_ports: int):
    """Enumerate all control REGs in srsLTE order (regs.c:733-760).

    Returns list of dicts: {l, k0, k(4,)} — k are the 4 data RE subcarriers."""
    max_ctrl = 4 if n_prb <= 10 else 3
    vo = cell_id % 3
    n = [_regs_per_symbol(i, n_ports) for i in range(max_ctrl)]
    regs = []
    for prb in range(n_prb):
        for jmax in range(3):
            for l in range(max_ctrl):
                if n[l] == 3 or (n[l] == 2 and jmax != 1):
                    j = sum(
                        1 for jm in range(jmax) if n[l] == 3 or (n[l] == 2 and jm != 1)
                    )
                    if n[l] == 2:
                        k0 = prb * 12 + j * 6
                        ks = [k0 + i for i in range(6) if i not in (vo, vo + 3)]
                    else:
                        k0 = prb * 12 + j * 4
                        ks = [k0 + i for i in range(4)]
                    regs.append(dict(l=l, k0=k0, k=np.array(ks, dtype=np.int32)))
    return regs


@functools.lru_cache(maxsize=None)
def channel_regs(n_prb: int, cell_id: int, n_ports: int, ng: str = "1"):
    """Assign REGs to PCFICH (4), PHICH groups (3 each), PDCCH (rest, per CFI).

    Returns dict with:
      pcfich: (4,) indices into reg_table
      phich:  (ngroups, 3) indices
      pdcch:  {cfi: (n_regs,) reg indices in quadruplet order}
    """
    regs = reg_table(n_prb, cell_id, n_ports)
    assigned = np.zeros(len(regs), dtype=bool)

    # --- PCFICH (regs.c:491-517) ---
    k_hat = 6 * (cell_id % (2 * n_prb))
    pcfich = []
    by_lk0 = {(r["l"], r["k0"]): i for i, r in enumerate(regs)}
    for i in range(4):
        k = (k_hat + (i * n_prb // 2) * 6) % (n_prb * 12)
        idx = by_lk0[(0, k)]
        pcfich.append(idx)
        assigned[idx] = True

    # --- PHICH, normal duration (regs.c:245-345) ---
    ngroups = int(np.ceil(PHICH_NG[ng] * n_prb / 8))
    l0 = [i for i, r in enumerate(regs) if r["l"] == 0 and not assigned[i]]
    n0 = len(l0)
    phich = np.zeros((ngroups, 3), dtype=np.int64)
    for mi in range(ngroups):
        for i in range(3):
            ni = (cell_id + mi + i * n0 // 3) % n0
            phich[mi, i] = l0[ni]
            assigned[l0[ni]] = True

    # --- PDCCH per CFI (regs.c:77-140) ---
    pdcch = {}
    for cfi in (1, 2, 3):
        ncs = n_ctrl_symbols(cfi, n_prb)
        tmp = [i for i, r in enumerate(regs) if r["l"] < ncs and not assigned[i]]
        nof = len(tmp)
        nrows = (nof - 1) // 32 + 1
        ndummy = 32 * nrows - nof
        out = np.zeros(nof, dtype=np.int64)
        k = 0
        for j in range(32):
            for i in range(nrows):
                if i * 32 + PDCCH_PERM[j] >= ndummy:
                    m = i * 32 + int(PDCCH_PERM[j]) - ndummy
                    kp = (k - cell_id) % nof
                    out[m] = tmp[kp]
                    k += 1
        pdcch[cfi] = out
    return dict(pcfich=np.array(pcfich), phich=phich, pdcch=pdcch)


def reg_re_indices(n_prb: int, cell_id: int, n_ports: int, reg_ids) -> np.ndarray:
    """Flat grid indices (l*NRE + k) of the 4 REs of each REG: (len, 4)."""
    regs = reg_table(n_prb, cell_id, n_ports)
    nre = 12 * n_prb
    ids = np.asarray(reg_ids)
    flat_ids = ids.reshape(-1)
    out = np.zeros((len(flat_ids), 4), dtype=np.int32)
    for i, rid in enumerate(flat_ids):
        r = regs[int(rid)]
        out[i] = r["l"] * nre + r["k"]
    return out.reshape(ids.shape + (4,))
