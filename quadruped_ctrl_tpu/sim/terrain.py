"""Terrain library for the batched scenario engine.

The reference builds five PyBullet terrains (plane, random1 procedural
heightfield, random2 heightmap file, stairs, racetrack —
scripts/walking_simulation.py:93-159). Here terrain is a pure height
function h(x, y) parameterized by a small pytree, so thousands of scenarios
with different terrains batch under vmap. The heightfield grid size is a
free (static) parameter: any (H, W) works under jit, including the
reference random2's 256x256 heightmap file; terrains batched together must
share one grid (use `grid=` on the constructors / `resample`).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from quadruped_ctrl_tpu.core import struct

TERRAIN_PLANE = 0
TERRAIN_RANDOM = 1      # procedural heightfield (reference "random1")
TERRAIN_STAIRS = 2      # box steps (reference "stairs")
TERRAIN_SLOPE = 3
TERRAIN_HEIGHTMAP = 4   # heightmap array/file (reference "random2")

DEFAULT_GRID = (64, 64)
MAX_BOXES = 4           # static prop-slot count (unused slots are inert)


@struct.dataclass
class Terrain:
    """Batched terrain parameters; `kind` selects the height function.

    Box props (`box_*`) are STATIC OBSTACLES layered over any base kind:
    the reference's racetrack world ships models with real <collision>
    elements that PyBullet loads as solid props
    (/root/reference/worlds/racetrack_day.world:32-45,
    models/aws_robomaker_racetrack_Ground_01/model.sdf, parsed at
    scripts/walking_simulation.py:153-156). Here each prop is a yaw-rotated
    box; the contact query treats a box as its walkable top surface (the
    point-foot support height), so robots can step ONTO or walk PAST props.
    A true overhang (archway interior) is outside the support-height
    contact model — it renders in the camera scene but a foot under it
    contacts the base terrain.
    """

    kind: jnp.ndarray          # () int32
    # heightfield: (H, W) grid, scale meters/cell
    heightfield: jnp.ndarray   # (H, W) — any static shape
    cell_size: jnp.ndarray     # ()
    # stairs: step depth/height along +x from x0
    stair_depth: jnp.ndarray   # ()
    stair_height: jnp.ndarray  # ()
    stair_x0: jnp.ndarray      # ()
    # box props: center (K,3), half-extent (K,3), yaw (K,); half_z == 0
    # marks an empty slot
    box_center: jnp.ndarray    # (MAX_BOXES, 3)
    box_half: jnp.ndarray      # (MAX_BOXES, 3)
    box_yaw: jnp.ndarray       # (MAX_BOXES,)
    # slope: grade in x. NOTE: must stay the LAST field — the `slope`
    # STATICMETHOD below shares its name, so dataclasses picks the method
    # object up as this field's default; any field declared after it would
    # be a non-default-after-default TypeError.
    slope: jnp.ndarray         # ()

    @staticmethod
    def plane(grid=DEFAULT_GRID):
        return Terrain(
            kind=jnp.asarray(TERRAIN_PLANE, jnp.int32),
            heightfield=jnp.zeros(grid, jnp.float32),
            cell_size=jnp.asarray(0.1, jnp.float32),
            stair_depth=jnp.asarray(0.2, jnp.float32),
            stair_height=jnp.asarray(0.02, jnp.float32),
            stair_x0=jnp.asarray(1.0, jnp.float32),
            slope=jnp.asarray(0.0, jnp.float32),
            box_center=jnp.zeros((MAX_BOXES, 3), jnp.float32),
            box_half=jnp.zeros((MAX_BOXES, 3), jnp.float32),
            box_yaw=jnp.zeros((MAX_BOXES,), jnp.float32),
        )

    def with_boxes(self, centers, halves, yaws=None):
        """Place up to MAX_BOXES solid box props on this terrain.

        centers/halves: (k, 3) world center and half-extents; yaws: (k,)
        rotation about z (default 0). Slots beyond k stay inert."""
        centers = jnp.asarray(centers, jnp.float32).reshape(-1, 3)
        halves = jnp.asarray(halves, jnp.float32).reshape(-1, 3)
        k = centers.shape[0]
        assert k <= MAX_BOXES and halves.shape[0] == k
        yaws = (jnp.zeros((k,), jnp.float32) if yaws is None
                else jnp.asarray(yaws, jnp.float32).reshape(-1))
        return self.replace(
            box_center=self.box_center.at[:k].set(centers),
            box_half=self.box_half.at[:k].set(halves),
            box_yaw=self.box_yaw.at[:k].set(yaws),
        )

    @staticmethod
    def random(key, amplitude=0.03, cell_size=0.1, grid=DEFAULT_GRID):
        """Procedural rough ground (reference random1: +-0.06 m cells,
        walking_simulation.py:101-119; amplitude is halved by default for the
        point-foot SRB model)."""
        hf = jax.random.uniform(key, grid, jnp.float32, 0.0, amplitude)
        base = Terrain.plane(grid)
        return base.replace(
            kind=jnp.asarray(TERRAIN_RANDOM, jnp.int32),
            heightfield=hf,
            cell_size=jnp.asarray(cell_size, jnp.float32),
        )

    @staticmethod
    def from_array(arr, cell_size=0.5, z_scale=1.0, grid=None):
        """Terrain from an arbitrary heightmap array — the reference
        "random2" (walking_simulation.py:120-130: GEOM_HEIGHTFIELD from
        heightmaps/ground0.txt with meshScale [.5,.5,.5]).

        The array (any resolution, e.g. 256x256) is nearest-resampled to
        `grid` (default: its own shape) so heightmap terrains can batch with
        the other kinds; heights are shifted so the grid-center cell sits at
        z=0 (the robot spawns at the origin on the terrain surface).
        """
        hf = np.asarray(arr, dtype=np.float32) * float(z_scale)
        if grid is not None and tuple(hf.shape) != tuple(grid):
            # cell size scales with the resampling so world extent is kept
            cell_size = cell_size * hf.shape[0] / grid[0]
            ix = (np.arange(grid[0]) * hf.shape[0] / grid[0]).astype(int)
            iy = (np.arange(grid[1]) * hf.shape[1] / grid[1]).astype(int)
            hf = hf[np.ix_(ix, iy)]
        hf = hf - hf[hf.shape[0] // 2, hf.shape[1] // 2]
        base = Terrain.plane(hf.shape)
        return base.replace(
            kind=jnp.asarray(TERRAIN_HEIGHTMAP, jnp.int32),
            heightfield=jnp.asarray(hf),
            cell_size=jnp.asarray(cell_size, jnp.float32),
        )

    @staticmethod
    def from_file(path: str, cell_size=0.5, z_scale=0.5, grid=None):
        """Load a heightmap file: .txt (the reference random2's format),
        .npy, or an image (grayscale/255 -> height). Defaults mirror the
        reference's meshScale [.5,.5,.5] (walking_simulation.py:122-125)."""
        low = path.lower()
        if low.endswith(".txt"):
            arr = np.loadtxt(path)
        elif low.endswith(".npy"):
            arr = np.load(path)
        else:
            from PIL import Image

            arr = np.asarray(Image.open(path).convert("L"),
                             dtype=np.float32) / 255.0
        return Terrain.from_array(arr, cell_size=cell_size, z_scale=z_scale,
                                  grid=grid)

    @staticmethod
    def stairs(depth=0.2, height=0.02, x0=1.0, grid=DEFAULT_GRID):
        base = Terrain.plane(grid)
        return base.replace(
            kind=jnp.asarray(TERRAIN_STAIRS, jnp.int32),
            stair_depth=jnp.asarray(depth, jnp.float32),
            stair_height=jnp.asarray(height, jnp.float32),
            stair_x0=jnp.asarray(x0, jnp.float32),
        )

    @staticmethod
    def slope(grade=0.1, grid=DEFAULT_GRID):
        base = Terrain.plane(grid)
        return base.replace(
            kind=jnp.asarray(TERRAIN_SLOPE, jnp.int32),
            slope=jnp.asarray(grade, jnp.float32),
        )


def box_support(terrain: Terrain, x, y):
    """Support height contributed by box props at world (x, y): the top
    face of any box whose (yaw-rotated) footprint contains the point,
    -inf elsewhere. Broadcasts like height_at."""
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    dx = x[..., None] - terrain.box_center[:, 0]
    dy = y[..., None] - terrain.box_center[:, 1]
    c, s = jnp.cos(terrain.box_yaw), jnp.sin(terrain.box_yaw)
    lx = c * dx + s * dy
    ly = -s * dx + c * dy
    inside = (
        (jnp.abs(lx) <= terrain.box_half[:, 0])
        & (jnp.abs(ly) <= terrain.box_half[:, 1])
        & (terrain.box_half[:, 2] > 0.0)
    )
    top = terrain.box_center[:, 2] + terrain.box_half[:, 2]
    return jnp.max(jnp.where(inside, top, -jnp.inf), axis=-1)


def box_occupancy(terrain: Terrain, pts):
    """Boolean: world points pts (..., 3) inside any box prop's VOLUME
    (yaw-rotated, z-bounded) — the true-3D query the camera renderer uses,
    so overhanging/floating props image correctly even though the contact
    model only sees their support height."""
    d = pts[..., None, :] - terrain.box_center                 # (...,K,3)
    c, s = jnp.cos(terrain.box_yaw), jnp.sin(terrain.box_yaw)
    lx = c * d[..., 0] + s * d[..., 1]
    ly = -s * d[..., 0] + c * d[..., 1]
    inside = (
        (jnp.abs(lx) <= terrain.box_half[:, 0])
        & (jnp.abs(ly) <= terrain.box_half[:, 1])
        & (jnp.abs(d[..., 2]) <= terrain.box_half[:, 2])
        & (terrain.box_half[:, 2] > 0.0)
    )
    return jnp.any(inside, axis=-1)


def base_height_at(terrain: Terrain, x, y):
    """Height of the base terrain KIND alone (no box props); broadcasts
    over trailing dims."""
    hw = terrain.heightfield.shape
    gx = jnp.clip(x / terrain.cell_size + hw[0] / 2, 0, hw[0] - 1).astype(jnp.int32)
    gy = jnp.clip(y / terrain.cell_size + hw[1] / 2, 0, hw[1] - 1).astype(jnp.int32)
    h_field = terrain.heightfield[gx, gy]
    h_stairs = jnp.clip(
        jnp.floor((x - terrain.stair_x0) / terrain.stair_depth) + 1, 0, 4
    ) * terrain.stair_height
    h_slope = terrain.slope * x
    zero = jnp.zeros_like(jnp.asarray(x, jnp.float32))
    return jnp.select(
        [
            (terrain.kind == TERRAIN_RANDOM)
            | (terrain.kind == TERRAIN_HEIGHTMAP),
            terrain.kind == TERRAIN_STAIRS,
            terrain.kind == TERRAIN_SLOPE,
        ],
        [h_field, h_stairs, h_slope],
        zero,
    )


def height_at(terrain: Terrain, x, y):
    """Terrain SUPPORT height at world (x, y) — the contact query;
    broadcasts over trailing dims. Box props (racetrack-style collision
    models) stack over the base kind via max: a foot on a prop footprint
    contacts the prop top."""
    return jnp.maximum(base_height_at(terrain, x, y),
                       box_support(terrain, x, y))
