"""Photo-consistency refinement of a gridded surface (the grid's --refine).

Counterpart of wass_tpu/grid/variational.py (the reference's experimental
TFVariationalRefinement, gridding/wassgridsurface/TFVariationalRefinement.py:
18-133, off by default in both packages): the gridded Z (meters, the
setup's XY grid, z flipped) is optimised with Adam at 1/coarse_factor
resolution.  The loss is the mean squared difference of the two
undistorted images sampled through the surface's projections (data term)
plus alpha times the mean squared derivative-of-Gaussian gradient of Z
(smoothness); the result is upsampled and NaN outside the mask.  A grid
node (X, Y, Z) maps to the camera frame as
    p_cam = Rpl^T ((X, Y, -Z) / baseline - Tpl).

The gradient is torch.autograd's.  The coarse start is an antialiased
bilinear down-resize (jax.image.resize antialiases when it shrinks); the
up-resize is a product with separable bilinear matrices (half-pixel
centres, edges clamped: jax.image.resize's weights when it grows), whose
backward is a product too, so no step adds with atomics; the
derivative-of-Gaussian convolutions run with cuDNN's deterministic
algorithms.  The 3x3 and 3x4 products are written out elementwise.

On the card the whole Adam step (the loss, its gradient and the update,
the step counter a device tensor) is captured once per grid and image
shape in a CUDA graph, and replayed max_iters times: eagerly a step is
~100 small launches.  Two replays on the same inputs give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from wass_tpu_torch.ops.sampling import bilinear_sample

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-7  # the reference's tf.keras Adam
_GRAPHS: dict = {}


def _dog_kernels(n: int = 7, sigma: float = 0.8):
    """Derivative-of-Gaussian x/y kernels (reference :9-15), float64 numpy
    cast to float32."""
    x = np.exp(-0.5 * ((np.arange(n) - n // 2) / sigma) ** 2)
    w = np.outer(x, x)
    return np.gradient(w, axis=1).astype(np.float32), np.gradient(w, axis=0).astype(np.float32)


def up_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) float32 bilinear resize weights: half-pixel centres,
    the source position clamped to the input (jax.image.resize's
    "bilinear" when n_out >= n_in, F.interpolate's align_corners=False)."""
    src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = src - i0
    A = np.zeros((n_out, n_in))
    np.add.at(A, (np.arange(n_out), i0), 1.0 - frac)
    np.add.at(A, (np.arange(n_out), i1), frac)
    return A.astype(np.float32)


def down_resize(Z: torch.Tensor, shape) -> torch.Tensor:
    """jax.image.resize(Z, shape, "bilinear") for a smaller shape: the
    antialiased (widened, normalised) triangle filter."""
    return F.interpolate(Z[None, None], size=tuple(shape), mode="bilinear", align_corners=False,
                         antialias=True)[0, 0]


def deterministic_cudnn():
    """cuDNN restricted to its deterministic convolution algorithms (the
    backward's too, so hold it around the gradient), TF32 off."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)


def _affine_rows(M: torch.Tensor, x, y, z):
    """M[:, :3] @ (x, y, z) + M[:, 3] for a (3, 4) M, each row
    ((m0 x + m1 y) + m2 z) + m3."""
    return [((M[i, 0] * x + M[i, 1] * y) + M[i, 2] * z) + M[i, 3] for i in range(3)]


class _Refiner:
    """The refinement of one grid shape, image shape and set of scalars:
    static input and state tensors, the loss and the Adam step, so that a
    CUDA graph of the step can be replayed on new inputs copied in."""

    def __init__(self, shape, img_shape, coarse_factor: int, alpha: float, lr: float, baseline: float, device):
        H, W = shape
        self.shape = (H, W)
        self.coarse = (H // coarse_factor, W // coarse_factor)
        self.alpha, self.lr, self.baseline = float(alpha), float(lr), float(baseline)
        f32 = dict(dtype=torch.float32, device=device)
        self.Ay = torch.as_tensor(up_matrix(H, self.coarse[0]), **f32)
        self.AxT = torch.as_tensor(up_matrix(W, self.coarse[1]).T.copy(), **f32)
        self.kernels = torch.as_tensor(np.stack(_dog_kernels())[:, None], **f32)  # (2, 1, 7, 7)
        # Per-call inputs (copied in by load()).
        self.Xp, self.Yp, self.m = (torch.zeros((H, W), **f32) for _ in range(3))
        self.I0, self.I1 = (torch.zeros(img_shape, **f32) for _ in range(2))
        self.P0, self.P1, self.camT = (torch.zeros((3, 4), **f32) for _ in range(3))  # camT: [R_c | T_c]
        # Optimiser state.
        self.Zc = torch.zeros(self.coarse, **f32).requires_grad_(True)
        self.mu, self.nu = torch.zeros(self.coarse, **f32), torch.zeros(self.coarse, **f32)
        self.t = torch.zeros((), **f32)
        self.last_loss = torch.zeros((), **f32)

    def load(self, Zc0, I0, I1, P0, P1, camT, Xp, Yp, m) -> None:
        with torch.no_grad():
            for dst, src in ((self.Zc, Zc0), (self.I0, I0), (self.I1, I1), (self.P0, P0), (self.P1, P1),
                             (self.camT, camT), (self.Xp, Xp), (self.Yp, Yp), (self.m, m)):
                dst.copy_(src)
            self.mu.zero_()
            self.nu.zero_()
            self.t.zero_()

    def upsample(self, Zc: torch.Tensor) -> torch.Tensor:
        return torch.matmul(torch.matmul(self.Ay, Zc), self.AxT)

    def _sample(self, img, P, pc):
        u, v, w = _affine_rows(P, *pc)
        w = torch.clamp_min(w, 1e-6)
        return bilinear_sample(img, u / w, v / w)

    def loss(self, Zc: torch.Tensor) -> torch.Tensor:
        Zfull = self.upsample(Zc)
        pc = _affine_rows(self.camT, self.Xp, self.Yp, -Zfull / self.baseline)
        s0 = self._sample(self.I0, self.P0, pc) * self.m / 255.0
        s1 = self._sample(self.I1, self.P1, pc) * self.m / 255.0
        data = torch.mean(torch.square(s0 - s1))
        grads = F.conv2d(Zfull[None, None], self.kernels, padding=3)[0]
        smooth = torch.mean(torch.square(grads[0]) + torch.square(grads[1]))
        return data + self.alpha * smooth

    def step(self) -> None:
        """One Adam step of the in-module optimiser (wass_tpu/grid/
        variational.py:118-130), in place on the state."""
        with deterministic_cudnn():
            loss = self.loss(self.Zc)
            (g,) = torch.autograd.grad(loss, self.Zc)
        with torch.no_grad():
            self.t.add_(1.0)
            mu = B1 * self.mu + (1.0 - B1) * g
            nu = B2 * self.nu + (1.0 - B2) * g * g
            mhat = mu / (1.0 - torch.pow(B1, self.t))
            nhat = nu / (1.0 - torch.pow(B2, self.t))
            self.Zc.copy_(self.Zc - self.lr * mhat / (torch.sqrt(nhat) + ADAM_EPS))
            self.mu.copy_(mu)
            self.nu.copy_(nu)
            self.last_loss.copy_(loss)


def _graph(ref: _Refiner) -> "torch.cuda.CUDAGraph":
    """A CUDA graph of ref.step(), after warm-up steps on a side stream (the
    state is reloaded before every use)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            ref.step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ref.step()
    return graph


def variational_refine(Z, I0, I1, P0cam, P1cam, Rpl, Tpl, XX, YY, baseline, mask, max_iters: int = 400,
                       alpha: float = 10.0, lr: float = 1e-3, coarse_factor: int = 2, use_graph=None,
                       stats=None) -> torch.Tensor:
    """Refine the gridded surface Z (meters) by photo-consistency, on Z's
    device.

    Z: (H, W) gridded elevation tensor (NaNs allowed outside mask).
    I0, I1: the undistorted camera images (0..255; tensors or arrays).
    P0cam, P1cam: 3x4 projection matrices (cam0 frame, baseline-normalized:
    the workdir's P0cam.txt/P1cam.txt).  Rpl, Tpl: the grid setup's
    sea-plane alignment.  XX, YY: the grid (meters).  mask: (H, W) {0,1}.
    use_graph: replay a CUDA graph of the step (the default on the card;
    False runs the steps eagerly).  stats: a dict that receives the loss
    of the first step ("loss_first") and of the result ("loss_last").

    Returns (H, W) refined Z, float32, NaN outside the mask."""
    dev = Z.device
    H, W = Z.shape
    f32 = dict(dtype=torch.float32, device=dev)
    use_graph = dev.type == "cuda" if use_graph is None else use_graph
    if use_graph and dev.type != "cuda":
        raise ValueError("variational_refine: use_graph needs a CUDA device")
    img0, img1 = (torch.as_tensor(i, device=dev).to(torch.float32) for i in (I0, I1))
    # The plane -> camera transform in float32, as the JAX function: R_c =
    # Rpl^T, T_c = -R_c Tpl (each row summed in order).
    R_c = np.asarray(Rpl, np.float32).T
    Tp = np.asarray(Tpl, np.float32).reshape(3)
    T_c = np.array([-((R_c[i, 0] * Tp[0] + R_c[i, 1] * Tp[1]) + R_c[i, 2] * Tp[2]) for i in range(3)], np.float32)
    camT = np.concatenate([R_c, T_c[:, None]], 1)
    b32 = np.float32(baseline)
    Xp = np.asarray(XX, np.float32) / b32
    Yp = np.asarray(YY, np.float32) / b32
    m = torch.as_tensor(mask, **f32)

    key = (dev, (H, W), tuple(img0.shape), coarse_factor, float(alpha), float(lr), float(baseline))
    entry = _GRAPHS.get(key) if use_graph else None
    ref = entry[0] if entry else _Refiner((H, W), tuple(img0.shape), coarse_factor, alpha, lr, baseline, dev)
    Zc0 = down_resize(torch.nan_to_num(Z.to(torch.float32)), ref.coarse)
    inputs = (Zc0, img0, img1, torch.as_tensor(np.asarray(P0cam, np.float32), **f32),
              torch.as_tensor(np.asarray(P1cam, np.float32), **f32), torch.as_tensor(camT, **f32),
              torch.as_tensor(Xp, **f32), torch.as_tensor(Yp, **f32), m)
    if use_graph and entry is None:
        ref.load(*inputs)
        entry = _GRAPHS[key] = (ref, _graph(ref))
    ref.load(*inputs)
    run = entry[1].replay if use_graph else ref.step
    for i in range(max_iters):
        run()
        if i == 0 and stats is not None:
            stats["loss_first"] = float(ref.last_loss)
    with torch.no_grad():
        Zc = ref.Zc.detach().clone()
        if stats is not None:
            with deterministic_cudnn():
                stats["loss_last"] = float(ref.loss(Zc))
        return torch.where(m > 0, ref.upsample(Zc), torch.nan)
