"""DTW alignment of text tokens to audio frames (port of stable_ts_tpu/ops/dtw.py).

The cost matrix C[i, j] = x[i-1, j-1] + min(C[i-1, j-1], C[i-1, j], C[i, j-1])
(C[0, 0] = 0, INF = 1e30 borders) comes from the CUDA kernel in
``csrc/dtw.cu`` on the GPU (producer warps take each row's prefix sums
ahead of the row chain, which carries only the prefix min) and from
:func:`dtw_cost_ref`, its plain twin, on the CPU. Both use the row algebra
of the JAX package (one prefix sum and one prefix min per row) with the
prefix sums in f64, rounded to f32 once, so the kernel and the twin
produce the same f32 costs.

The traceback (:func:`dtw_jumps`, :func:`dtw_jumps_batched` for a batch)
runs on the host over the downloaded cost matrix and returns exactly
``dtw_jumps_device``'s per-token jump frames: whisper's strict-< tie order
(diagonal only when strictly smallest, then up, ties move left), walking
from each matrix's real corner (n, m).
"""
import numpy as np
import torch

from .. import _build

INF = 1e30


def dtw_cost_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernel: x (B, N, M) f32 -> cost (B, N+1, M+1)."""
    x = x.float()
    batch, n, m = x.shape
    first = torch.full((batch, m + 1), INF, dtype=torch.float32,
                       device=x.device)
    first[:, 0] = 0.0
    inf_col = torch.full((batch, 1), INF, dtype=torch.float32, device=x.device)
    rows = [first]
    prev = first
    for i in range(n):
        a = torch.minimum(prev[:, :-1], prev[:, 1:])
        s = torch.cumsum(x[:, i].double(), dim=-1).float()
        s_prev = torch.cat([torch.zeros_like(s[:, :1]), s[:, :-1]], dim=-1)
        running = torch.cummin(a - s_prev, dim=-1).values
        prev = torch.cat([inf_col, torch.clamp(s + running, max=INF)], dim=-1)
        rows.append(prev)
    return torch.stack(rows, dim=1)


def dtw_cost(x: torch.Tensor) -> torch.Tensor:
    """DTW cost matrices. x: (N, M) or (B, N, M) -> (…, N+1, M+1) f32.

    A CPU tensor goes to the plain twin; a CUDA tensor to the kernel."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    if x.device.type == 'cpu':
        cost = dtw_cost_ref(x)
    elif x.device.type == 'cuda':
        cost = _dtw_cost_cuda(x)
    else:
        raise ValueError(f'dtw_cost: unsupported device {x.device}')
    return cost[0] if squeeze else cost


def _dtw_cost_cuda(x: torch.Tensor) -> torch.Tensor:
    x = x.float().contiguous()
    batch, n, m = x.shape
    if not 1 <= m <= 4096:
        raise ValueError(f'dtw_cost kernel takes 1 <= M <= 4096, got {m}')
    cost = torch.empty((batch, n + 1, m + 1), dtype=torch.float32,
                       device=x.device)
    lib = _build.lib()
    _build.check(lib.dtw_cost(x.data_ptr(), cost.data_ptr(), batch, n, m,
                              _build.stream_ptr(x)), 'dtw_cost')
    _build.launches['dtw_cost'] += 1
    return cost


def dtw_jumps(cost: np.ndarray, n: int, m: int) -> np.ndarray:
    """Per-token jump frames from one (R+1, F+1) cost matrix, walking from
    (n, m): row t holds the frame of text row t's first path point. Rows
    the walk never leaves (t >= n) stay 0, as on device."""
    cost = np.asarray(cost, dtype=np.float32)
    jt = np.zeros(cost.shape[0] - 1, np.int32)
    i, j = int(n), int(m)
    while i > 0 or j > 0:
        im1, jm1 = max(i - 1, 0), max(j - 1, 0)
        c_diag = cost[im1, jm1]
        c_up = cost[im1, j]
        c_left = cost[i, jm1]
        diag = c_diag < c_up and c_diag < c_left
        up = c_up < c_diag and c_up < c_left and not diag
        diag = diag and i > 0 and j > 0
        up = i > 0 if j == 0 else (up and i > 0)
        if diag or up:
            jt[im1] = jm1
            i -= 1
        if diag or not (diag or up):
            j -= 1
    return jt


def dtw_jumps_batched(cost: np.ndarray, n_rows, m_cols) -> np.ndarray:
    """:func:`dtw_jumps` of each window of a (B, R+1, F+1) cost batch,
    walking from (n_rows[b], m_cols[b]): (B, R) int32, equal to JAX's
    ``dtw_jumps_device`` (ops/dtw.py:231-278). The batched driver downloads
    the group's costs once and walks them here; padded rows past a window's
    corner are never read. A window read a little past 30 s (a loader
    rounds its chunks up) has one frame more than the matrix: its walk
    starts at the last column, where JAX's clamped reads send it."""
    cost = np.asarray(cost, dtype=np.float32)
    last = cost.shape[-1] - 1
    return np.stack([dtw_jumps(c, int(n), min(int(m), last))
                     for c, n, m in zip(cost, n_rows, m_cols)])
