"""Floating-base rigid-body dynamics for the Mini-Cheetah (18 DoF).

The batched-JAX counterpart of the reference's FloatingBaseModel
(src/Dynamics/FloatingBaseModel.{cpp,h}, built by Quadruped::buildModel,
src/Dynamics/Quadruped.cpp:117-206): a fixed 13-body kinematic tree (base +
4x abad/hip/knee) with the MiniCheetah.h:19-112 CAD inertias, supporting

* forward kinematics + foot (ground-contact-point) positions/velocities,
* generalized mass matrix via the Composite Rigid Body Algorithm,
* bias forces (Coriolis + gravity) via the Recursive Newton-Euler Algorithm,
* world-frame contact Jacobians,
* forward dynamics qdd = M^-1 (tau - h) (the reference's runABA computes the
  same quantity by a different recursion; here CRBA+RNEA+solve keeps the
  whole computation batched matmuls with static shapes),
* rotor (gearbox) handling EXACTLY as the reference's explicit geared rotor
  bodies (Quadruped.cpp:117-206, MiniCheetah.h:51-109): each rotor's full
  spatial inertia (mass 0.055 kg, axisymmetric about its spin axis) enters
  through the Srot = gear * axis motion subspace and the parent->rotor
  Xuprot transform, carrying the gear^2 spin term on the joint diagonal,
  the static X' I X part on the parent, AND the gear^1 couplings
  Xuprot'(Irot Srot) in CRBA/RNEA/ABA (see `_rotor_xforms`, `mass_matrix`,
  `inverse_dynamics`, `aba_qdd`). Golden-tested against the compiled
  reference's rotor-exact CRBA/ABA (tests/test_dynamics_golden.py: mass
  matrix ~6e-4 abs, ABA qdd ~1e-4 rad/s^2); total mass 8.91 kg matches the
  MPC's 9 kg SRB.

Velocity convention: `base_vel` is the base's spatial velocity [omega; v] in
BASE coordinates; q (12,) joint angles in the leg_kinematics convention
(abad +X, hip/knee -Y rotations); generalized coordinate order
[base(6), leg0(3), ..., leg3(3)].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_ctrl_tpu.config import RobotConfig
from quadruped_ctrl_tpu.models import spatial as sp

N_BODIES = 13           # base + 4 legs x 3 links
N_DOF = 18

# per-moving-body: (parent body index, joint axis, joint sign)
# bodies 1..12 = [abad, hip, knee] x legs 0..3
_JOINT_AXIS = [0, 1, 1]        # abad about X, hip/knee about Y
_JOINT_SIGN = [1.0, -1.0, -1.0]


def _mirror_y(inertia, side):
    """Reflect a rotational inertia across the xz-plane for right legs."""
    s = np.diag([1.0, side, 1.0])
    return s @ inertia @ s


class MiniCheetahModel:
    """Precomputed tree constants (numpy); methods are pure jnp functions."""

    def __init__(self, robot: RobotConfig | None = None):
        r = robot or RobotConfig()
        self.robot = r
        l1, l2, l3 = r.abad_link_length, r.hip_link_length, r.knee_link_length
        l4 = r.knee_link_y_offset

        parents = [ -1 ]
        x_tree = [np.eye(6, dtype=np.float32)]
        inertias = [
            sp.spatial_inertia(
                jnp.asarray(r.body_mass),
                jnp.zeros(3),
                jnp.asarray(np.diag([11253e-6, 36203e-6, 42673e-6]), jnp.float32),
            )
        ]
        abad_i = np.array([[381, 58, 0.45], [58, 560, 0.95], [0.45, 0.95, 444]]) * 1e-6
        # The reference expresses the hip body in a Rz(pi)-rotated frame
        # (xtreeHip, Quadruped.cpp:168-171); this model keeps all leg frames
        # axis-aligned with the abad frame, so the hip CAD inertia/CoM
        # (MiniCheetah.h:69-73) conjugate by diag(-1,-1,1): the xz/yz
        # products flip sign (xy is invariant) and the CoM x/y negate.
        hip_i = np.array([[1983, 245, -13], [245, 2103, -1.5], [-13, -1.5, 408]]) * 1e-6
        knee_i_rotated = np.diag([6e-6, 248e-6, 245e-6])
        ry = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], dtype=np.float64)
        knee_i = ry @ knee_i_rotated @ ry.T

        hips = r.hip_locations()
        for leg in range(4):
            side = r.side_signs[leg]
            base_idx = len(parents)
            # abad: at the hip mount, rotates about +X
            parents.append(0)
            x_tree.append(np.asarray(
                sp.xform(jnp.eye(3), jnp.asarray(hips[leg]))))
            inertias.append(
                sp.spatial_inertia(
                    jnp.asarray(0.54),
                    jnp.asarray([0.0, side * 0.036, 0.0]),
                    jnp.asarray(_mirror_y(abad_i, side), jnp.float32),
                )
            )
            # hip: offset (0, side*l1, 0) from abad, rotates about -Y
            parents.append(base_idx)
            x_tree.append(np.asarray(
                sp.xform(jnp.eye(3), jnp.asarray([0.0, side * l1, 0.0]))))
            inertias.append(
                sp.spatial_inertia(
                    jnp.asarray(0.634),
                    # Rz(pi)-frame CoM (0, 0.016, -0.02) maps to -y here
                    jnp.asarray([0.0, -side * 0.016, -0.02]),
                    jnp.asarray(_mirror_y(hip_i, side), jnp.float32),
                )
            )
            # knee: offset (0,0,-l2) from hip, rotates about -Y
            parents.append(base_idx + 1)
            x_tree.append(np.asarray(
                sp.xform(jnp.eye(3), jnp.asarray([0.0, 0.0, -l2]))))
            inertias.append(
                sp.spatial_inertia(
                    jnp.asarray(0.064),
                    jnp.asarray([0.0, 0.0, -0.061]),
                    jnp.asarray(_mirror_y(knee_i, side), jnp.float32),
                )
            )

        # Explicit geared rotors (MiniCheetah.h:51-109, Quadruped.cpp:117-206):
        # each moving body i has a rotor attached to its PARENT at a fixed
        # translation, spinning about the joint axis at gear * q_i. Stored
        # per moving body (1..12): the rotor spatial inertia (mass 0.055,
        # CoM 0, diag 63e-6 spin / 33e-6 transverse — axisymmetric, so its
        # parent-coordinate static part X_rot' I_rot X_rot is CONSTANT), the
        # parent->rotor translation, and the gear ratio. Abad rotors sit on
        # the base at withLegSigns(0.125, 0.049, 0); hip rotors on the abad
        # at (0, side*0.04, 0); knee rotors at the hip origin.
        i_spin_x = np.diag([63e-6, 33e-6, 33e-6])   # abad rotors spin about X
        i_spin_y = np.diag([33e-6, 63e-6, 33e-6])   # hip/knee rotors about Y
        rotor_mass = 0.055
        gears = [r.abad_gear_ratio, r.hip_gear_ratio, r.knee_gear_ratio]
        rotor_inertia = []      # 6x6 spatial, rotor coords (axisymmetric)
        rotor_xtree = []        # parent -> rotor-frame-at-zero (translation)
        for leg in range(4):
            side = r.side_signs[leg]
            locs = [
                [0.125 * float(np.sign(hips[leg][0])), side * 0.049, 0.0],
                [0.0, side * 0.04, 0.0],
                [0.0, 0.0, 0.0],
            ]
            for j in range(3):
                i_rot = i_spin_x if j == 0 else i_spin_y
                rotor_inertia.append(np.asarray(sp.spatial_inertia(
                    jnp.asarray(rotor_mass), jnp.zeros(3),
                    jnp.asarray(i_rot, jnp.float32))))
                rotor_xtree.append(np.asarray(sp.xform(
                    jnp.eye(3), jnp.asarray(locs[j], jnp.float32))))
        self.rotor_inertia = [jnp.asarray(x, jnp.float32) for x in rotor_inertia]
        self.rotor_xtree = [jnp.asarray(x, jnp.float32) for x in rotor_xtree]
        self.gear = [float(gears[j % 3]) for j in range(12)]
        # constants exploiting rotor axisymmetry (transverse inertias equal,
        # CoM on the spin axis): Xuprot' Irot Xuprot and Xuprot' (Irot Srot)
        # are INDEPENDENT of the rotor angle, so both are precomputed here.
        rotor_static, urot_parent = [], []
        for b in range(12):
            x = jnp.asarray(rotor_xtree[b], jnp.float32)
            i_rot = jnp.asarray(rotor_inertia[b], jnp.float32)
            rotor_static.append(x.T @ i_rot @ x)
            srot = (_JOINT_SIGN[b % 3] * self.gear[b]
                    * sp.joint_motion_subspace(_JOINT_AXIS[b % 3]))
            urot_parent.append(x.T @ (i_rot @ srot))
        self.rotor_static = rotor_static       # 6x6, parent coords
        self.urot_parent = urot_parent         # (6,), parent coords

        self.parents = parents
        self.x_tree = [jnp.asarray(x, jnp.float32) for x in x_tree]
        self.inertias = [jnp.asarray(np.asarray(i), jnp.float32) for i in inertias]
        # foot contact point in knee coordinates
        self.foot_offsets = [
            jnp.asarray([0.0, r.side_signs[leg] * l4, -l3], jnp.float32)
            for leg in range(4)
        ]
        # reflected rotor inertia per joint [abad, hip, knee] x 4
        spin = 63e-6
        self.rotor_refl = jnp.asarray(
            [r.abad_gear_ratio**2 * spin, r.hip_gear_ratio**2 * spin,
             r.knee_gear_ratio**2 * spin] * 4,
            jnp.float32,
        )

    # ---------------------------------------------------------------- core
    def _joint_xforms(self, q12):
        """Per-moving-body joint transform X_J and motion subspace S."""
        xj, s_list = [], []
        for b in range(12):
            axis = _JOINT_AXIS[b % 3]
            sign = _JOINT_SIGN[b % 3]
            theta = sign * q12[b]
            xj.append(sp.joint_xform(axis, theta))
            s_list.append(sign * sp.joint_motion_subspace(axis))
        return xj, s_list

    def _kinematics(self, q12):
        """Xup[i]: transform from parent coordinates into body i coordinates."""
        xj, s_list = self._joint_xforms(q12)
        xup = [None] * N_BODIES
        xup[0] = jnp.eye(6, dtype=jnp.float32)
        for i in range(1, N_BODIES):
            xup[i] = xj[i - 1] @ self.x_tree[i]
        return xup, s_list

    def _body_to_base(self, xup):
        """X from base coordinates to each body's coordinates."""
        x0 = [None] * N_BODIES
        x0[0] = jnp.eye(6, dtype=jnp.float32)
        for i in range(1, N_BODIES):
            x0[i] = xup[i] @ x0[self.parents[i]]
        return x0

    # ------------------------------------------------------------ kinematics
    def foot_positions_base(self, q12):
        """(4,3) foot positions in base coordinates (== hip offset + leg FK)."""
        xup, _ = self._kinematics(q12)
        x0 = self._body_to_base(xup)
        feet = []
        for leg in range(4):
            knee = 3 + leg * 3
            feet.append(self._point_in_base(x0[knee], self.foot_offsets[leg]))
        return jnp.stack(feet)

    def _point_in_base(self, x0_body, point_body):
        """Transform a point from body coordinates to base coordinates.

        For X = [[E,0],[-E px, E]] mapping base->body, a body-frame point pb
        is at E^T pb + o where o (body origin in base coords) satisfies
        -E [o]x = lower-left block => recover o from E^T and the block.
        """
        e = x0_body[0:3, 0:3]
        skew = x0_body[3:6, 0:3]            # = -E [o]x
        ox = -e.T @ skew                     # [o]x
        o = jnp.stack([ox[2, 1], ox[0, 2], ox[1, 0]])
        return o + e.T @ point_body

    def _rotor_xforms(self, q12):
        """Per-moving-body rotor transform Xuprot (parent->rotor) and geared
        motion subspace Srot = sign * gear * axis (rotor coords) — the
        reference's _Xuprot/_Srot (FloatingBaseModel.cpp
        updateArticulatedBodies)."""
        xuprot, srot = [], []
        for b in range(12):
            axis = _JOINT_AXIS[b % 3]
            sign = _JOINT_SIGN[b % 3]
            g = self.gear[b]
            xuprot.append(
                sp.joint_xform(axis, sign * g * q12[b]) @ self.rotor_xtree[b]
            )
            srot.append(sign * g * sp.joint_motion_subspace(axis))
        return xuprot, srot

    # --------------------------------------------------------------- CRBA
    def mass_matrix(self, q12):
        """Generalized mass matrix (18,18): [base(6), joints(12)], with the
        reference's exact geared-rotor terms (FloatingBaseModel.cpp:752-811):
        rotor statics in the composite recursion, gear^2 spin inertia on the
        joint diagonal, and the gear^1 coupling Xuprot'(Irot Srot) on every
        joint-ancestor column."""
        xup, s_list = self._kinematics(q12)
        ic = list(self.inertias)

        m = jnp.zeros((N_DOF, N_DOF), jnp.float32)
        for i in range(N_BODIES - 1, 0, -1):
            p = self.parents[i]
            ic[p] = (
                ic[p]
                + sp.xform_force(sp.inv_xform(xup[i])) @ ic[i] @ xup[i]
                + self.rotor_static[i - 1]
            )

        # joint-joint and joint-base terms
        for i in range(1, N_BODIES):
            si = s_list[i - 1]
            f = ic[i] @ si                       # (6,)
            m = m.at[6 + i - 1, 6 + i - 1].set(si @ f + self.rotor_refl[i - 1])
            # into parent coordinates, with the rotor gear^1 coupling
            fi = (sp.xform_force(sp.inv_xform(xup[i])) @ f
                  + self.urot_parent[i - 1])
            j = self.parents[i]
            while j > 0:
                m = m.at[6 + i - 1, 6 + j - 1].set(fi @ s_list[j - 1])
                m = m.at[6 + j - 1, 6 + i - 1].set(fi @ s_list[j - 1])
                fi = sp.xform_force(sp.inv_xform(xup[j])) @ fi
                j = self.parents[j]
            m = m.at[0:6, 6 + i - 1].set(fi)
            m = m.at[6 + i - 1, 0:6].set(fi)

        m = m.at[0:6, 0:6].set(ic[0])
        return m

    # --------------------------------------------------------------- RNEA
    def bias_forces(self, q12, qd12, base_vel, gravity=9.81):
        """Generalized bias h(q, v) (Coriolis + gravity), (18,).

        base_vel: base spatial velocity [omega; v] in base coordinates.
        Gravity enters as a fictitious base acceleration (RNEA standard).
        """
        xup, s_list = self._kinematics(xq := q12)
        x0 = self._body_to_base(xup)

        # gravity in base coordinates: the caller supplies base orientation
        # via rot_base_to_world when needed; here base z-up is assumed by
        # passing a rotated gravity through `gravity_vec_base`.
        a_grav = jnp.concatenate(
            [jnp.zeros(3, jnp.float32), jnp.asarray([0.0, 0.0, gravity], jnp.float32)]
        )

        xuprot, srot = self._rotor_xforms(q12)
        v = [None] * N_BODIES
        a = [None] * N_BODIES
        f = [None] * N_BODIES
        frot = [None] * N_BODIES
        v[0] = base_vel
        a[0] = a_grav  # -(-g): accelerating the base frame upward
        f[0] = self.inertias[0] @ a[0] + sp.force_cross(v[0]) @ (
            self.inertias[0] @ v[0]
        )
        for i in range(1, N_BODIES):
            p = self.parents[i]
            si = s_list[i - 1]
            vj = si * qd12[i - 1]
            v[i] = xup[i] @ v[p] + vj
            a[i] = xup[i] @ a[p] + sp.motion_cross(v[i]) @ vj
            f[i] = self.inertias[i] @ a[i] + sp.force_cross(v[i]) @ (
                self.inertias[i] @ v[i]
            )
            # rotor bias force (generalizedCoriolisForce's _fvprot)
            i_rot = self.rotor_inertia[i - 1]
            vjr = srot[i - 1] * qd12[i - 1]
            vrot = xuprot[i - 1] @ v[p] + vjr
            arot = xuprot[i - 1] @ a[p] + sp.motion_cross(vrot) @ vjr
            frot[i] = i_rot @ arot + sp.force_cross(vrot) @ (i_rot @ vrot)

        h = jnp.zeros((N_DOF,), jnp.float32)
        for i in range(N_BODIES - 1, 0, -1):
            h = h.at[6 + i - 1].set(
                s_list[i - 1] @ f[i] + srot[i - 1] @ frot[i]
            )
            p = self.parents[i]
            f[p] = (f[p] + sp.xform_force(sp.inv_xform(xup[i])) @ f[i]
                    + sp.xform_force(sp.inv_xform(xuprot[i - 1])) @ frot[i])
        h = h.at[0:6].set(f[0])
        return h

    def bias_forces_oriented(self, q12, qd12, base_vel, r_body, gravity=9.81):
        """bias with base orientation: gravity rotated into base coords."""
        g_base = r_body @ jnp.asarray([0.0, 0.0, gravity], jnp.float32)
        h_flat = self.bias_forces(q12, qd12, base_vel, gravity=0.0)
        # add gravity as base acceleration: equivalent to RNEA with
        # a[0] += [0; g_base]; recompute via the linearity in a_grav:
        h_grav = self._gravity_terms(q12, g_base)
        return h_flat + h_grav

    def _gravity_terms(self, q12, g_base):
        xup, s_list = self._kinematics(q12)
        xuprot, srot = self._rotor_xforms(q12)
        a_grav = jnp.concatenate([jnp.zeros(3, jnp.float32), g_base])
        a = [None] * N_BODIES
        f = [None] * N_BODIES
        frot = [None] * N_BODIES
        a[0] = a_grav
        f[0] = self.inertias[0] @ a[0]
        for i in range(1, N_BODIES):
            a[i] = xup[i] @ a[self.parents[i]]
            f[i] = self.inertias[i] @ a[i]
            frot[i] = self.rotor_inertia[i - 1] @ (
                xuprot[i - 1] @ a[self.parents[i]]
            )
        h = jnp.zeros((N_DOF,), jnp.float32)
        for i in range(N_BODIES - 1, 0, -1):
            h = h.at[6 + i - 1].set(
                s_list[i - 1] @ f[i] + srot[i - 1] @ frot[i]
            )
            f[self.parents[i]] = (
                f[self.parents[i]]
                + sp.xform_force(sp.inv_xform(xup[i])) @ f[i]
                + sp.xform_force(sp.inv_xform(xuprot[i - 1])) @ frot[i]
            )
        h = h.at[0:6].set(f[0])
        return h

    # ----------------------------------------------------- contact Jacobians
    def contact_jacobians(self, q12):
        """(4, 3, 18) foot-point Jacobians in BASE coordinates: v_foot_base =
        J [base_vel; qd]."""
        xup, s_list = self._kinematics(q12)
        x0 = self._body_to_base(xup)
        jacs = []
        for leg in range(4):
            knee = 3 + leg * 3
            p_foot = self._point_in_base(x0[knee], self.foot_offsets[leg])
            jac = jnp.zeros((3, N_DOF), jnp.float32)
            # base contribution: v = v_base + omega x p
            jac = jac.at[:, 3:6].set(jnp.eye(3))
            px = jnp.array(
                [[0, -p_foot[2], p_foot[1]], [p_foot[2], 0, -p_foot[0]],
                 [-p_foot[1], p_foot[0], 0]], jnp.float32,
            )
            jac = jac.at[:, 0:3].set(-px)
            # joint contributions for this leg's three joints
            for jidx in range(3):
                body = 1 + leg * 3 + jidx
                # joint axis in base coordinates + joint origin
                e = x0[body][0:3, 0:3]       # base -> body rotation
                axis_body = s_list[body - 1][0:3]
                axis_base = e.T @ axis_body
                origin = self._point_in_base(x0[body], jnp.zeros(3, jnp.float32))
                arm = p_foot - origin
                jac = jac.at[:, 6 + leg * 3 + jidx].set(
                    jnp.cross(axis_base, arm)
                )
            jacs.append(jac)
        return jnp.stack(jacs)

    # ------------------------------------------------------ forward dynamics
    def forward_dynamics(self, q12, qd12, base_vel, tau12, r_body=None,
                         f_ext_feet=None, gravity=9.81):
        """qdd (18,) via M^-1 (tau + J^T f_ext - h).

        tau12: joint torques; f_ext_feet: optional (4,3) world... BASE-frame
        foot forces applied at the contact points.
        """
        m = self.mass_matrix(q12)
        if r_body is None:
            h = self.bias_forces(q12, qd12, base_vel, gravity)
        else:
            h = self.bias_forces_oriented(q12, qd12, base_vel, r_body, gravity)
        tau = jnp.concatenate([jnp.zeros(6, jnp.float32), tau12])
        if f_ext_feet is not None:
            jac = self.contact_jacobians(q12)
            tau = tau + jnp.einsum("fij,fi->j", jac, f_ext_feet)
        return jnp.linalg.solve(m, tau - h)

    # ------------------------------------------------------------------ ABA
    def aba(self, q12, qd12, base_vel, tau12, r_body=None, f_ext_feet=None,
            gravity=9.81):
        """Articulated-Body Algorithm: O(n) forward dynamics with a 6-DoF
        floating base (the reference's runABA, FloatingBaseModel.cpp:879-958).

        Same qdd (18,) as `forward_dynamics` (differential-tested); gravity
        and external foot forces enter as per-body external spatial forces,
        and the geared rotors carry the reference's EXACT recursion terms
        (Utot/d/u with Srot couplings, FloatingBaseModel.cpp:879-958 +
        updateArticulatedBodies) — golden-tested against the compiled
        reference in tests/test_dynamics_golden.py."""
        xup, s_list = self._kinematics(q12)
        x0 = self._body_to_base(xup)
        xuprot, srot = self._rotor_xforms(q12)
        g_world = jnp.asarray([0.0, 0.0, -gravity], jnp.float32)
        g_base = g_world if r_body is None else r_body @ g_world
        a_grav = jnp.concatenate([jnp.zeros(3, jnp.float32), g_base])

        fext = [jnp.zeros(6, jnp.float32) for _ in range(N_BODIES)]
        if f_ext_feet is not None:
            for leg in range(4):
                knee = 3 + leg * 3
                e = x0[knee][0:3, 0:3]                  # base -> knee rotation
                f_knee = e @ f_ext_feet[leg]            # force in knee coords
                p = self.foot_offsets[leg]
                fext[knee] = jnp.concatenate(
                    [jnp.cross(p, f_knee), f_knee]
                )

        # pass 1: velocities, velocity-product accelerations, bias forces
        # (gravity as the external force I_i X_{0->i} a_grav on every body,
        # and likewise -Irot X_{0->rot} a_grav on every rotor)
        v = [None] * N_BODIES
        c = [None] * N_BODIES
        crot = [None] * N_BODIES
        ia = [None] * N_BODIES
        pa = [None] * N_BODIES
        parot = [None] * N_BODIES
        v[0] = base_vel
        ia[0] = self.inertias[0]
        pa[0] = (
            sp.force_cross(v[0]) @ (self.inertias[0] @ v[0])
            - self.inertias[0] @ a_grav
            - fext[0]
        )
        for i in range(1, N_BODIES):
            p = self.parents[i]
            si = s_list[i - 1]
            vj = si * qd12[i - 1]
            v[i] = xup[i] @ v[p] + vj
            c[i] = sp.motion_cross(v[i]) @ vj
            ia[i] = self.inertias[i]
            pa[i] = (
                sp.force_cross(v[i]) @ (self.inertias[i] @ v[i])
                - self.inertias[i] @ (x0[i] @ a_grav)
                - fext[i]
            )
            i_rot = self.rotor_inertia[i - 1]
            vjr = srot[i - 1] * qd12[i - 1]
            vrot = xuprot[i - 1] @ v[p] + vjr
            crot[i] = sp.motion_cross(vrot) @ vjr
            parot[i] = (
                sp.force_cross(vrot) @ (i_rot @ vrot)
                - i_rot @ (xuprot[i - 1] @ (x0[p] @ a_grav))
            )

        # pass 2: articulated-body inertias inward (reference
        # updateArticulatedBodies + runABA loop 2, rotor-exact)
        utot_l = [None] * N_BODIES
        d_inv = [None] * N_BODIES
        u_sc = [None] * N_BODIES
        for i in range(N_BODIES - 1, 0, -1):
            si = s_list[i - 1]
            i_rot = self.rotor_inertia[i - 1]
            u = ia[i] @ si
            urot = i_rot @ srot[i - 1]
            xf = sp.xform_force(sp.inv_xform(xup[i]))
            utot = xf @ u + self.urot_parent[i - 1]     # parent coords
            d = si @ u + srot[i - 1] @ urot
            usc = (tau12[i - 1] - si @ pa[i] - srot[i - 1] @ parot[i]
                   - u @ c[i] - urot @ crot[i])
            p = self.parents[i]
            xfrot = sp.xform_force(sp.inv_xform(xuprot[i - 1]))
            ia[p] = (
                ia[p] + xf @ ia[i] @ xup[i] + self.rotor_static[i - 1]
                - jnp.outer(utot, utot) / d
            )
            pa[p] = (
                pa[p] + xf @ (pa[i] + ia[i] @ c[i])
                + xfrot @ (parot[i] + i_rot @ crot[i])
                + utot * (usc / d)
            )
            utot_l[i], d_inv[i], u_sc[i] = utot, 1.0 / d, usc

        # pass 3: accelerations outward
        a = [None] * N_BODIES
        a[0] = jnp.linalg.solve(ia[0], -pa[0])
        qdd = jnp.zeros((12,), jnp.float32)
        for i in range(1, N_BODIES):
            ap = a[self.parents[i]]
            qdd_i = (u_sc[i] - utot_l[i] @ ap) * d_inv[i]
            a[i] = xup[i] @ ap + s_list[i - 1] * qdd_i + c[i]
            qdd = qdd.at[i - 1].set(qdd_i)
        return jnp.concatenate([a[0], qdd])

    # -------------------------------------- operational-space contact tools
    def inv_contact_inertia(self, q12):
        """(12,12) inverse operational-space inertia Lambda^-1 = J M^-1 J^T
        over all four foot contact points (3 rows each) — the reference's
        invContactInertia (FloatingBaseModel.cpp:1061-1106), computed as
        batched matmuls instead of the sparse factor recursion. The
        (4,3,3) per-foot blocks are the diagonal; off-diagonal blocks give
        inter-foot coupling."""
        m = self.mass_matrix(q12)
        jac = self.contact_jacobians(q12).reshape(12, N_DOF)
        minv_jt = jnp.linalg.solve(m, jac.T)            # (18,12)
        return jac @ minv_jt

    def apply_test_force(self, q12, leg: int, force_base):
        """Response to a test force at foot `leg` (reference applyTestForce,
        FloatingBaseModel.cpp:961-1050): returns (delta_v_foot (3,),
        delta_qd (18,)) per unit impulse — dv_foot = J_leg M^-1 J_leg^T f,
        dqd = M^-1 J_leg^T f."""
        m = self.mass_matrix(q12)
        jac = self.contact_jacobians(q12)[leg]          # (3,18)
        dqd = jnp.linalg.solve(m, jac.T @ force_base)
        return jac @ dqd, dqd

    # ------------------------------------------------- body-box contact set
    def box_contact_points(self):
        """(8,3) body-box corner contact points in base coordinates
        (reference addGroundContactBoxPoints, FloatingBaseModel.cpp:360-376,
        with dims (bodyLength, bodyWidth, bodyHeight), Quadruped.cpp:123-128)."""
        r = self.robot
        l, w, h = r.body_length, r.body_width, r.body_height
        corners = np.array(
            [[sx * l, sy * w, sz * h]
             for sz in (1.0, -1.0) for sy in (1.0, -1.0) for sx in (1.0, -1.0)],
            dtype=np.float32,
        ) / 2.0
        return jnp.asarray(corners)

    def box_point_jacobians(self):
        """(8,3,18) Jacobians of the box corner points (base body: base-rate
        columns only — v_p = v_base + omega x p, no joint contribution)."""
        pts = self.box_contact_points()
        jacs = []
        for k in range(8):
            p = pts[k]
            px = jnp.array(
                [[0.0, -p[2], p[1]], [p[2], 0.0, -p[0]], [-p[1], p[0], 0.0]],
                jnp.float32,
            )
            jac = jnp.zeros((3, N_DOF), jnp.float32)
            jac = jac.at[:, 0:3].set(-px).at[:, 3:6].set(jnp.eye(3))
            jacs.append(jac)
        return jnp.stack(jacs)

    def box_point_positions_world(self, base_p, r_body):
        """(8,3) world positions of the box corners; r_body maps world->base
        (StateEstimate.r_body convention)."""
        pts = self.box_contact_points()
        return base_p[None, :] + jnp.einsum("ij,ki->kj", r_body, pts)
