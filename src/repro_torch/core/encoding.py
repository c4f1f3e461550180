"""Dynamic encoding (paper §III-A, Alg. 1 + Fig. 2).

Selects per-dimension, data-driven (equi-depth) breakpoints for each of the
K*L projected dimensions and encodes projected coordinates into iSAX symbols
(region ids in [0, N_r), N_r = 256 by default, i.e. an 8-bit alphabet).

Breakpoint selection strategies:

  * ``sample_sort``      — sort a sample (n_s = 0.1 n in the paper) per
                           dimension and read off the N_r+1 order statistics;
  * ``full_sort``        — the paper's strawman: sort every coordinate;
  * ``histogram_refine`` — log-round histogram refinement: every round bins
                           the data by the current estimates and
                           re-interpolates all N_r-1 quantiles at once.

Sorting is exact, so ``full_sort`` and the fixed-stride ``sample_sort``
give the same breakpoints as the reference package on the same
coordinates.  Encoding is a row-wise binary search of each coordinate into
its dimension's inner breakpoints (Alg. 1 lines 5-8).
"""

from __future__ import annotations

from typing import Optional

import torch

DEFAULT_NR = 256


def _order_statistic_breakpoints(coords_sorted: torch.Tensor,
                                 Nr: int) -> torch.Tensor:
    """Equi-depth breakpoints from per-dimension sorted coords (m, D)->(D, Nr+1).

    B(1)=min, B(Nr+1)=max, B(z)=C_sorted[floor(m/Nr)*(z-1)], z=2..Nr
    (paper §III-A, 0-based here).
    """
    m = coords_sorted.shape[0]
    step = m // Nr
    idx = torch.clamp(torch.arange(1, Nr, device=coords_sorted.device) * step,
                      0, m - 1)                                    # (Nr-1,)
    inner = coords_sorted[idx, :]                                  # (Nr-1, D)
    lo = coords_sorted[0:1, :]
    hi = coords_sorted[m - 1:m, :]
    return torch.cat([lo, inner, hi], dim=0).T.contiguous()        # (D, Nr+1)


def _sort_columns(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=0, stable=True).values


def _enforce_monotone(bp: torch.Tensor) -> torch.Tensor:
    """Make each row non-decreasing (guards against degenerate duplicates)."""
    return torch.cummax(bp, dim=1).values


def breakpoints_sample_sort(coords: torch.Tensor, Nr: int = DEFAULT_NR, *,
                            generator: Optional[torch.Generator] = None,
                            sample_fraction: float = 0.1,
                            min_sample: int = 4096) -> torch.Tensor:
    """Breakpoints via sorting a sample.  coords: (n, D) -> (D, Nr+1).

    With ``generator=None`` the sample is the first ``n_s`` rows of the
    fixed-stride subsequence ``coords[::max(1, n//n_s)]``: deterministic
    for a given input and unbiased for any row order.  A generator draws an
    i.i.d. sample of the same shape (``randperm`` on the generator's
    device).
    """
    n, _ = coords.shape
    n_s = min(n, max(min_sample, int(n * sample_fraction)))
    if generator is not None and n_s < n:
        sel = torch.randperm(n, generator=generator,
                             device=generator.device)[:n_s]
        sample = coords[sel.to(coords.device), :]
    else:
        stride = max(1, n // n_s)                 # floor: >= n_s rows remain
        sample = coords[::stride][:n_s, :]
    bp = _order_statistic_breakpoints(_sort_columns(sample), Nr)
    # True min/max must come from the full data so every point is coverable.
    bp[:, 0] = coords.amin(dim=0)
    bp[:, Nr] = coords.amax(dim=0)
    return _enforce_monotone(bp)


def _searchsorted_rows(edges: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Row-wise searchsorted(side='right'): edges (D, E), x (n, D) -> (n, D)."""
    return torch.searchsorted(edges.contiguous(), x.T.contiguous(),
                              right=True).T


def histogram_counts(coords: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Per-dimension histogram over ``edges``: (n, D), (D, Nr+1) -> (D, Nr).

    Bin b counts points with edges[d, b] <= x < edges[d, b+1] (last bin
    right-closed).
    """
    D, E = edges.shape
    Nr = E - 1
    bins = torch.clamp(_searchsorted_rows(edges[:, 1:Nr], coords), 0, Nr - 1)
    counts = torch.zeros((D, Nr), dtype=torch.int64, device=coords.device)
    counts.scatter_add_(1, bins.T, torch.ones_like(bins.T))
    return counts.to(torch.int32)


def refine_breakpoints_from_counts(edges: torch.Tensor, counts: torch.Tensor,
                                   n_total: int) -> torch.Tensor:
    """One refinement round: re-interpolate all Nr-1 quantiles from counts.

    edges: (D, Nr+1) current estimates; counts: (D, Nr) histogram over edges.
    Returns updated (D, Nr+1) edges (min/max endpoints preserved).
    """
    D, Nr = counts.shape
    dev = edges.device
    cum = torch.cat([torch.zeros((D, 1), dtype=torch.float32, device=dev),
                     torch.cumsum(counts.to(torch.float32), dim=1)],
                    dim=1)                                         # (D, Nr+1)
    targets = ((torch.arange(1, Nr, dtype=torch.float32, device=dev) / Nr)
               * torch.tensor(n_total, dtype=torch.float32, device=dev))
    b = torch.searchsorted(cum.contiguous(),
                           targets.expand(D, Nr - 1).contiguous(),
                           right=True) - 1
    b = torch.clamp(b, 0, Nr - 1)                                  # (D, Nr-1)
    c0 = torch.gather(cum, 1, b)
    c1 = torch.gather(cum, 1, b + 1)
    w = (targets[None, :] - c0) / torch.clamp(c1 - c0, min=1e-9)
    w = torch.clamp(w, 0.0, 1.0)
    e0 = torch.gather(edges, 1, b)
    e1 = torch.gather(edges, 1, b + 1)
    inner = e0 + w * (e1 - e0)
    out = torch.cat([edges[:, :1], inner, edges[:, -1:]], dim=1)
    return _enforce_monotone(out)


def breakpoints_histogram_refine(coords: torch.Tensor, Nr: int = DEFAULT_NR,
                                 *, rounds: int = 8) -> torch.Tensor:
    """Breakpoints via iterative histogram refinement.  (n, D) -> (D, Nr+1).

    log2(Nr) = 8 rounds mirrors the paper's divide-and-conquer depth.
    """
    n = coords.shape[0]
    lo = coords.amin(dim=0)
    hi = coords.amax(dim=0)
    t = torch.arange(Nr + 1, dtype=torch.float32, device=coords.device) / Nr
    edges = lo[:, None] + (hi - lo)[:, None] * t[None, :]          # uniform init
    for _ in range(rounds):
        edges = refine_breakpoints_from_counts(
            edges, histogram_counts(coords, edges), n)
    return edges


def full_sort(coords: torch.Tensor, Nr: int = DEFAULT_NR) -> torch.Tensor:
    """The paper's strawman: order statistics of every coordinate."""
    return _enforce_monotone(
        _order_statistic_breakpoints(_sort_columns(coords), Nr))


def select_breakpoints(coords: torch.Tensor, Nr: int = DEFAULT_NR, *,
                       method: str = "sample_sort",
                       generator: Optional[torch.Generator] = None,
                       sample_fraction: float = 0.1,
                       rounds: int = 8) -> torch.Tensor:
    """Dispatch: (n, D) projected coords -> (D, Nr+1) breakpoints."""
    if method == "sample_sort":
        return breakpoints_sample_sort(coords, Nr, generator=generator,
                                       sample_fraction=sample_fraction)
    if method == "full_sort":
        return full_sort(coords, Nr)
    if method == "histogram_refine":
        return breakpoints_histogram_refine(coords, Nr, rounds=rounds)
    raise ValueError(f"unknown breakpoint method: {method}")


def encode(coords: torch.Tensor, breakpoints: torch.Tensor, *,
           impl: str = "auto") -> torch.Tensor:
    """Encode coords (n, D) with breakpoints (D, Nr+1) -> region ids (n, D).

    Region b satisfies B[d, b] <= x <= B[d, b+1] (int32 in [0, Nr-1]).
    impl: 'auto'/'xla' -> a row-wise ``torch.searchsorted``, which puts a
    NaN coordinate past every edge (Nr-1), as the reference's jnp oracle
    does; 'pallas' -> the ``encode_bins`` kernel on a CUDA tensor (its
    plain version ``kernels.ref.encode_bins`` on a CPU one), which codes a
    NaN 0, as the TPU kernel does; 'pallas_interpret' -> that plain version
    on either device.
    """
    if impl in ("pallas", "pallas_interpret"):
        from repro_torch.kernels import ops
        return ops.encode_bins(coords, breakpoints,
                               interpret=(impl == "pallas_interpret"))
    Nr = breakpoints.shape[1] - 1
    bins = _searchsorted_rows(breakpoints[:, 1:Nr], coords)
    return torch.clamp(bins, 0, Nr - 1).to(torch.int32)
