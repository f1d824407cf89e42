"""Attributes framework: tensor-like scene attributes with batch prefixes.

Reference: nr3d_lib/models/attributes/ — `Attr`/`AttrNested` tensor-like
nn.Modules with slicing/stack/interp and arbitrary batch prefixes
(attr.py:38-247); SO3 variants (Quaternion/AxisAngle/6D/Mat3x3) and SE3
variants (RT/Mat4x4/ExpSE3) sharing `transform/rotate/mat_3x4/mat_4x4/inv/
interp1d` (transform.py:62-385); camera-intrinsics family with a common
lift/proj API (camera_param.py:62-538); `Segment` validity intervals
(segment.py:92).

Design: attributes are registered pytrees (`nn.pytree_dataclass`
frozen dataclasses) — they slice/stack with jax tree ops, pass through jit
unchanged, and are optimizable (pose refinement) by making them leaves of
the param tree.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp

from nr3d_lib_tpu.maths.slerp import slerp
from nr3d_lib_tpu.maths.transforms import (
    axis_angle_to_quaternion, matrix_to_quaternion, quaternion_to_matrix,
    rotation_6d_to_matrix)
from nr3d_lib_tpu.nn import pytree_dataclass, static_field

__all__ = [
    "RotationQuaternion", "RotationAxisAngle", "Rotation6D", "RotationMat3x3",
    "TransformRT", "TransformMat4x4", "TransformExpSE3", "Scale",
    "PinholeCameraIntrinsics", "PinholeCameraMatHW", "PinholeCameraHWF",
    "PinholeCameraHWFRatio",
    "PinholeCameraHWFExp", "OpenCVCameraIntrinsics",
    "FisheyeCameraIntrinsics", "OrthoCameraIntrinsics", "Segment",
    "attr_index", "attr_stack", "attr_concat", "attr_interp1d",
]

Array = jax.Array


# ------------------------------------------------------------------ SO3 reps
class _RotBase:
    def mat_3x3(self) -> Array:
        raise NotImplementedError

    def rotate(self, v: Array) -> Array:
        return jnp.einsum("...ij,...j->...i", self.mat_3x3(), v)

    def inv_rotate(self, v: Array) -> Array:
        return jnp.einsum("...ji,...j->...i", self.mat_3x3(), v)


@pytree_dataclass
class RotationQuaternion(_RotBase):
    q: Array  # [..., 4] (w,x,y,z)

    def mat_3x3(self) -> Array:
        return quaternion_to_matrix(self.q)

    def interp1d(self, other: "RotationQuaternion", alpha) -> "RotationQuaternion":
        return RotationQuaternion(slerp(self.q, other.q, alpha))

    @classmethod
    def from_matrix(cls, m: Array):
        return cls(matrix_to_quaternion(m))


@pytree_dataclass
class RotationAxisAngle(_RotBase):
    aa: Array  # [..., 3]

    def mat_3x3(self) -> Array:
        return quaternion_to_matrix(axis_angle_to_quaternion(self.aa))


@pytree_dataclass
class Rotation6D(_RotBase):
    d6: Array  # [..., 6]

    def mat_3x3(self) -> Array:
        return rotation_6d_to_matrix(self.d6)


@pytree_dataclass
class RotationMat3x3(_RotBase):
    m: Array  # [..., 3, 3]

    def mat_3x3(self) -> Array:
        return self.m


# ------------------------------------------------------------------ SE3 reps
class _TransformBase:
    def mat_4x4(self) -> Array:
        m34 = self.mat_3x4()
        bottom = jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 0.0, 1.0], m34.dtype),
            m34.shape[:-2] + (1, 4))
        return jnp.concatenate([m34, bottom], axis=-2)

    def transform(self, pts: Array) -> Array:
        m = self.mat_3x4()
        return jnp.einsum("...ij,...j->...i", m[..., :3], pts) + m[..., 3]

    def rotate(self, v: Array) -> Array:
        return jnp.einsum("...ij,...j->...i", self.mat_3x4()[..., :3], v)


@pytree_dataclass
class TransformRT(_TransformBase):
    """rotation (quaternion) + translation (reference transform.py RT)."""

    rot: Array    # [..., 4] quaternion
    trans: Array  # [..., 3]

    def mat_3x4(self) -> Array:
        r = quaternion_to_matrix(self.rot)
        return jnp.concatenate([r, self.trans[..., None]], -1)

    def inv(self) -> "TransformRT":
        r_inv = self.rot * jnp.asarray([1.0, -1, -1, -1], self.rot.dtype)
        t_inv = -jnp.einsum("...ji,...j->...i",
                            quaternion_to_matrix(self.rot), self.trans)
        return TransformRT(r_inv, t_inv)

    def interp1d(self, other: "TransformRT", alpha) -> "TransformRT":
        """slerp rotation + lerp translation (reference interp1d)."""
        return TransformRT(slerp(self.rot, other.rot, alpha),
                           self.trans * (1 - alpha) + other.trans * alpha)

    @classmethod
    def from_mat4x4(cls, m: Array):
        return cls(matrix_to_quaternion(m[..., :3, :3]), m[..., :3, 3])


@pytree_dataclass
class TransformMat4x4(_TransformBase):
    m: Array  # [..., 4, 4]

    def mat_3x4(self) -> Array:
        return self.m[..., :3, :]

    def mat_4x4(self) -> Array:
        return self.m

    def inv(self) -> "TransformMat4x4":
        r = self.m[..., :3, :3]
        t = self.m[..., :3, 3]
        r_t = jnp.swapaxes(r, -1, -2)
        t_inv = -jnp.einsum("...ij,...j->...i", r_t, t)
        top = jnp.concatenate([r_t, t_inv[..., None]], -1)
        bottom = jnp.broadcast_to(jnp.asarray([0.0, 0, 0, 1], self.m.dtype),
                                  self.m.shape[:-2] + (1, 4))
        return TransformMat4x4(jnp.concatenate([top, bottom], -2))


@pytree_dataclass
class TransformExpSE3(_TransformBase):
    """se(3) exponential-map pose: unit screw axis (w, v) and angle θ —
    the pose-refinement parameterization (reference: transform.py:341
    TransformExpSE3, after iNeRF). Identity at (w, v, θ) = 0; gradients
    w.r.t. the 7 scalars flow through Rodrigues + the SE3 V-matrix."""

    w: Array      # [..., 3] rotation axis (need not be normalized at init)
    v: Array      # [..., 3] translation direction
    theta: Array  # [...]

    @classmethod
    def identity(cls, shape=()):
        return cls(jnp.zeros(shape + (3,)), jnp.zeros(shape + (3,)),
                   jnp.zeros(shape))

    def _pieces(self):
        w = self.w
        zeros = jnp.zeros_like(w[..., 0])
        w_ss = jnp.stack([
            jnp.stack([zeros, -w[..., 2], w[..., 1]], -1),
            jnp.stack([w[..., 2], zeros, -w[..., 0]], -1),
            jnp.stack([-w[..., 1], w[..., 0], zeros], -1)], -2)
        w_ss2 = w_ss @ w_ss
        th = self.theta[..., None, None]
        eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype),
                               w.shape[:-1] + (3, 3))
        rot = eye + jnp.sin(th) * w_ss + (1 - jnp.cos(th)) * w_ss2
        V = eye * th + (1 - jnp.cos(th)) * w_ss + (th - jnp.sin(th)) * w_ss2
        return rot, jnp.einsum("...ij,...j->...i", V, self.v)

    def mat_3x4(self) -> Array:
        rot, trans = self._pieces()
        return jnp.concatenate([rot, trans[..., None]], -1)

    def to_rt(self) -> "TransformRT":
        rot, trans = self._pieces()
        return TransformRT(matrix_to_quaternion(rot), trans)


@pytree_dataclass
class Scale:
    """Per-axis scale attr (reference attr scale family)."""

    s: Array  # [..., 3]

    def ratio3d(self) -> Array:
        return self.s

    def apply(self, pts: Array) -> Array:
        return pts * self.s


# ---------------------------------------------------------------- intrinsics
class _IntrBase:
    def mat_3x3(self) -> Array:
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack([
            jnp.stack([self.fx, z, self.cx], -1),
            jnp.stack([z, self.fy, self.cy], -1),
            jnp.stack([z, z, o], -1)], -2)

    def lift(self, uv: Array, depth: Optional[Array] = None) -> Array:
        from nr3d_lib_tpu.graphics.cameras import pinhole_lift

        return pinhole_lift(uv, self.mat_3x3(), depth)

    def proj(self, x_cam: Array) -> Tuple[Array, Array]:
        from nr3d_lib_tpu.graphics.cameras import pinhole_project

        return pinhole_project(x_cam, self.mat_3x3())


@pytree_dataclass
class PinholeCameraIntrinsics(_IntrBase):
    """(fx, fy, cx, cy) + image size (reference camera_param.py Pinhole)."""

    fx: Array
    fy: Array
    cx: Array
    cy: Array
    H: int = static_field(default=0)
    W: int = static_field(default=0)

    @classmethod
    def from_mat(cls, mat: Array, H: int = 0, W: int = 0):
        return cls(mat[..., 0, 0], mat[..., 1, 1], mat[..., 0, 2],
                   mat[..., 1, 2], H, W)

    def downscale(self, factor: float) -> "PinholeCameraIntrinsics":
        f = 1.0 / factor
        return PinholeCameraIntrinsics(self.fx * f, self.fy * f,
                                       self.cx * f, self.cy * f,
                                       int(self.H // factor), int(self.W // factor))


@pytree_dataclass
class PinholeCameraMatHW(_IntrBase):
    """Full 3×3 matrix parameterization (reference camera_param.py:292
    PinholeCameraMatHW — the fifth pinhole form): the matrix IS the
    parameter (skewed/refined K supported), fx/fy/cx/cy are views."""

    mat: Array                      # [..., 3, 3]
    H: int = static_field(default=0)
    W: int = static_field(default=0)

    def mat_3x3(self) -> Array:
        return self.mat

    @property
    def fx(self):
        return self.mat[..., 0, 0]

    @property
    def fy(self):
        return self.mat[..., 1, 1]

    @property
    def cx(self):
        return self.mat[..., 0, 2]

    @property
    def cy(self):
        return self.mat[..., 1, 2]

    def downscale(self, factor: float) -> "PinholeCameraMatHW":
        s = jnp.asarray([1.0 / factor, 1.0 / factor, 1.0])
        return PinholeCameraMatHW(self.mat * s[:, None],
                                  int(self.H // factor),
                                  int(self.W // factor))


@pytree_dataclass
class PinholeCameraHWF(_IntrBase):
    """Single shared focal length (reference camera_param.py:403
    PinholeCameraHWF). fx = fy = f."""

    f: Array
    cx: Array
    cy: Array
    H: int = static_field(default=0)
    W: int = static_field(default=0)

    @property
    def fx(self):
        return self.f

    @property
    def fy(self):
        return self.f


@pytree_dataclass
class PinholeCameraHWFRatio(_IntrBase):
    """Focal stored as a ratio of image size (reference camera_param.py:367
    PinholeCameraHWFxyRatio): fx = rx·W, fy = ry·H — resolution-invariant,
    the natural parameterization for joint intrinsics refinement."""

    rx: Array
    ry: Array
    cx: Array
    cy: Array
    H: int = static_field(default=0)
    W: int = static_field(default=0)

    @property
    def fx(self):
        return self.rx * self.W

    @property
    def fy(self):
        return self.ry * self.H


@pytree_dataclass
class PinholeCameraHWFExp(_IntrBase):
    """Log-focal parameterization (reference camera_param.py:119
    FocalRatioExp): fx = exp(log_fx) — keeps a refined focal positive with
    scale-free gradient steps."""

    log_fx: Array
    log_fy: Array
    cx: Array
    cy: Array
    H: int = static_field(default=0)
    W: int = static_field(default=0)

    @property
    def fx(self):
        return jnp.exp(self.log_fx)

    @property
    def fy(self):
        return jnp.exp(self.log_fy)


@pytree_dataclass
class OpenCVCameraIntrinsics(PinholeCameraIntrinsics):
    """Pinhole + OpenCV distortion (reference camera_param.py OpenCV)."""

    dist: Array = None  # [..., >=4]

    def proj(self, x_cam: Array) -> Tuple[Array, Array]:
        from nr3d_lib_tpu.graphics.cameras import opencv_distort

        z = x_cam[..., 2]
        xn = x_cam[..., :2] / z[..., None]
        xd = opencv_distort(xn, self.dist)
        u = xd[..., 0] * self.fx + self.cx
        v = xd[..., 1] * self.fy + self.cy
        return jnp.stack([u, v], -1), z

    def lift(self, uv: Array, depth: Optional[Array] = None) -> Array:
        from nr3d_lib_tpu.graphics.cameras import opencv_undistort

        xd = jnp.stack([(uv[..., 0] - self.cx) / self.fx,
                        (uv[..., 1] - self.cy) / self.fy], -1)
        xn = opencv_undistort(xd, self.dist)
        z = jnp.ones_like(uv[..., 0]) if depth is None else depth
        return jnp.concatenate([xn * z[..., None], z[..., None]], -1)


@pytree_dataclass
class FisheyeCameraIntrinsics(PinholeCameraIntrinsics):
    """Pinhole + equidistant fisheye (reference camera_param.py Fisheye)."""

    dist: Array = None  # [..., 4]

    def proj(self, x_cam: Array) -> Tuple[Array, Array]:
        from nr3d_lib_tpu.graphics.cameras import fisheye_distort

        z = x_cam[..., 2]
        xn = x_cam[..., :2] / z[..., None]
        xd = fisheye_distort(xn, self.dist)
        u = xd[..., 0] * self.fx + self.cx
        v = xd[..., 1] * self.fy + self.cy
        return jnp.stack([u, v], -1), z

    def lift(self, uv: Array, depth: Optional[Array] = None) -> Array:
        from nr3d_lib_tpu.graphics.cameras import fisheye_undistort

        xd = jnp.stack([(uv[..., 0] - self.cx) / self.fx,
                        (uv[..., 1] - self.cy) / self.fy], -1)
        xn = fisheye_undistort(xd, self.dist)
        z = jnp.ones_like(uv[..., 0]) if depth is None else depth
        return jnp.concatenate([xn * z[..., None], z[..., None]], -1)


@pytree_dataclass
class OrthoCameraIntrinsics(_IntrBase):
    """Orthographic (reference camera_param.py Ortho)."""

    sx: Array
    sy: Array
    cx: Array
    cy: Array
    H: int = static_field(default=0)
    W: int = static_field(default=0)

    def lift(self, uv: Array, depth: Optional[Array] = None) -> Array:
        z = jnp.ones_like(uv[..., 0]) if depth is None else depth
        x = (uv[..., 0] - self.cx) / self.sx
        y = (uv[..., 1] - self.cy) / self.sy
        return jnp.stack([x, y, z], -1)

    def proj(self, x_cam: Array) -> Tuple[Array, Array]:
        u = x_cam[..., 0] * self.sx + self.cx
        v = x_cam[..., 1] * self.sy + self.cy
        return jnp.stack([u, v], -1), x_cam[..., 2]


# ----------------------------------------------------------- attr utilities
# The reference's AttrNested framework (attr.py:38-247) gives every
# attribute slicing / stacking / interp over arbitrary batch prefixes via
# per-class bookkeeping. Attributes here are dataclass pytrees, so the
# same operations are four generic tree functions working on ANY attr —
# including nested containers (dicts/tuples of attrs).

def attr_index(attr, idx):
    """attr[idx] over the leading batch axis (reference Attr.__getitem__)."""
    return jax.tree_util.tree_map(lambda leaf: leaf[idx], attr)


def attr_stack(attrs, axis: int = 0):
    """Stack same-type attrs along a new batch axis (reference Attr.stack)."""
    return jax.tree_util.tree_map(
        lambda *leaves: jnp.stack(leaves, axis), *attrs)


def attr_concat(attrs, axis: int = 0):
    """Concatenate along an existing batch axis (reference Attr.concat)."""
    return jax.tree_util.tree_map(
        lambda *leaves: jnp.concatenate(leaves, axis), *attrs)


def attr_interp1d(a, b, alpha):
    """Interpolate between two same-type attrs (reference Attr.interp1d):
    classes defining their own `interp1d` (slerp-based rotations/transforms)
    use it; everything else lerps leaf-wise. Nested containers recurse."""
    if hasattr(a, "interp1d"):
        return a.interp1d(b, alpha)
    if isinstance(a, dict):
        return {k: attr_interp1d(a[k], b[k], alpha) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(attr_interp1d(x, y, alpha) for x, y in zip(a, b))
    if isinstance(a, (jax.Array, jnp.ndarray)) or not hasattr(a, "__dict__"):
        return a * (1 - alpha) + b * alpha
    # pytree dataclass without custom interp1d: recurse field-wise
    fields = {k: attr_interp1d(getattr(a, k), getattr(b, k), alpha)
              for k, leaf in vars(a).items()
              if isinstance(leaf, (jax.Array, jnp.ndarray))}
    return a.replace(**fields)


# ------------------------------------------------------------------ segment
@pytree_dataclass
class Segment:
    """Validity interval per entity (reference segment.py:92): an entity
    exists for frame indices in [start, stop)."""

    start: Array  # [...]
    stop: Array   # [...]

    def valid(self, t: Array) -> Array:
        return (t >= self.start) & (t < self.stop)

    def length(self) -> Array:
        return self.stop - self.start
