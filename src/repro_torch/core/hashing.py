"""p-stable LSH projections (paper §II-B, Eq. 1).

h(o) = a . o with a ~ N(0, I_d).  DET-LSH uses K*L such functions, giving L
independent K-dimensional projected spaces:  H_i(o) in R^K, i = 1..L.

The projection is one tall-skinny float32 matrix product, left to
``torch.matmul`` as the reference leaves it to XLA's dot, unless a build
asks for the ``lsh_project`` kernel (``impl='pallas'``).
"""

from __future__ import annotations

import torch


def sample_projections(generator: torch.Generator, d: int, K: int, L: int,
                       device: torch.device | str) -> torch.Tensor:
    """Sample the (d, L*K) projection matrix A with i.i.d. N(0,1) entries.

    The draw happens on the generator's own device, so a CPU generator
    gives the same A whatever ``device`` the matrix is moved to."""
    a = torch.randn((d, L * K), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return a.to(device)


def project(data: torch.Tensor, A: torch.Tensor, *,
            impl: str = "auto") -> torch.Tensor:
    """Project ``data`` (n, d) or queries (..., d) -> (..., L*K) in f32.

    impl: 'auto'/'xla' -> ``torch.matmul``; 'pallas' -> the ``lsh_project``
    kernel on a CUDA tensor (its plain version on a CPU one);
    'pallas_interpret' -> that plain version on either device.  The kernel
    and its plain version take (n, d) rows and sum in d order.
    """
    if impl in ("pallas", "pallas_interpret"):
        from repro_torch.kernels import ops
        return ops.lsh_project(data, A,
                               interpret=(impl == "pallas_interpret"))
    return torch.matmul(data, A)
