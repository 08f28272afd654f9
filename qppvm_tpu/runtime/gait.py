"""Sustained gait: chain single-support cycles into locomotion.

The round-3 contact-switch machinery proved ONE lift/hold/re-plant cycle
(runtime/contact_switch.py); this module chains cycles into an N-stride
static walk — the BASELINE config-4 "contact switching at 1 kHz" executed
as *behavior*. A capability upgrade over the reference, whose contact set
is fixed at init (/root/reference/src/ForceAcc.cpp:58,74-96).

Design: each stride is one ``LegLiftScript`` cycle with a forward
``foothold_offset``. Stride geometry (support centroid, swing start pose)
is re-derived from the ACTUAL robot state at each stride boundary — the
script is open-loop within a stride and closed-loop across strides, so
tracking drift never accumulates. All phase changes are VALUES in the refs
pytree (gates, weights, gains, min-jerk PVA references); one compiled step
function serves the whole walk.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from qppvm_tpu.model import kinematics
from qppvm_tpu.runtime.contact_switch import LegLiftPhases, LegLiftScript


class GaitScript:
    """N-stride static walk (crawl gait: one swing foot at a time).

    Drive exactly like ``LegLiftScript``, but pass the current state so
    stride boundaries can re-anchor::

        gait = GaitScript(model, plugin, refs, initial_waist,
                          order=("foot_hl", "foot_fl", "foot_hr", "foot_fr"),
                          stride=(0.06, 0.0), n_strides=8)
        for i in range(gait.total):
            tau, warm, aux = plugin.control_loop(
                state, gait.refs_at(i, state), warm)

    ``order``: foot cycling order (hind foot before its ipsilateral front
    foot keeps the CoM inside the advancing support triangle).
    ``stride``: (dx, dy) world foothold displacement per swing.
    """

    def __init__(self, model, plugin, refs, initial_waist, *,
                 order: Sequence[str] = ("foot_hl", "foot_fl",
                                         "foot_hr", "foot_fr"),
                 stride: Tuple[float, float] = (0.06, 0.0),
                 n_strides: int = 4,
                 phases: Optional[LegLiftPhases] = None,
                 shift_mode: str = "centroid",
                 shift_a_max: Optional[float] = None,
                 shift_v_max: float = 0.25,
                 shift_ticks_max: Optional[int] = None,
                 unload_gate: Optional[Dict] = None,
                 com_servo: Optional[float] = None,
                 com_servo_max: float = 0.15,
                 relative_replant: bool = False,
                 tail: int = 300, **lift_kw):
        self.model = model
        self.plugin = plugin
        self.refs = dict(refs)
        self._waist = np.asarray(initial_waist, np.float64)
        # Nominal lateral offset per foot, captured at gait start. Each
        # swing LANDS at its nominal y instead of perpetuating whatever
        # lateral drift the stance phase accumulated — without this the
        # per-stride re-anchor ratchets cone-limited stance slip inward
        # until the support polygon degenerates to a line (measured: all
        # four feet within 4 cm of y=0 by stride 3, CoM outside the
        # polygon, tip-over). The swing is the only lateral drift-
        # correction channel a legged robot has; use it.
        self._y_nom = {c: float(np.asarray(refs[c + "_cartesian"]["p"])[1])
                       for c in plugin.contact_links}
        self.order = list(order)
        self.stride = (float(stride[0]), float(stride[1]))
        self.n_strides = int(n_strides)
        # Default stride phases: the validated leg-lift schedule with a
        # shorter settle (strides after the first start from a settled
        # single-support recovery, not from cold) and hold=0 (a walking
        # swing goes lift-off -> apex -> target without a pause).
        self.phases = phases or LegLiftPhases(
            settle=100, shift=350, dwell=100, unload=150,
            lift=250, hold=0, lower=250, reload=200)
        self.shift_mode = shift_mode
        # Capture-point-aware shift pacing (the round-4 humanoid 2nd-shift
        # fix): a min-jerk CoM transfer of distance D over T demands peak
        # CoM acceleration 5.77*D/T^2, which the contact CoP can only
        # supply while the ZMP excursion (z/g)*a stays inside the support
        # polygon behind the CoM. Stride k>0 of a biped step-in-place is a
        # DOUBLE-distance transfer (over-right -> over-left), so a fixed
        # shift duration that works from center violates that bound and
        # topples the robot at the 2nd weight shift (measured, round 4).
        # With ``shift_a_max`` set, each stride's shift duration is
        # re-derived from the ACTUAL transfer distance at the stride
        # boundary: T >= sqrt(5.77*D/a_max) (and >= 1.875*D/v_max),
        # floored at ``phases.shift`` and capped at ``shift_ticks_max``
        # (default 4x phases.shift). None keeps fixed durations (the
        # quadruped gait default, where per-stride transfers are short).
        self.shift_a_max = shift_a_max
        self.shift_v_max = float(shift_v_max)
        # Event-gated unload (the other half of the 2nd-shift fix): a
        # clock-driven schedule starts unloading while the CoM is still in
        # transit — it enters single support carrying transfer velocity,
        # the ICP leaves the stance patch and the robot skids (see the
        # capture-point pacing note above). With ``unload_gate`` set, the
        # script clock PAUSES at the unload boundary until the measured
        # CoM is over the remaining support and slow:
        #   {"tol_p": m, "tol_v": m/s, "max_extra": ticks}
        # (max_extra bounds the pause; on timeout the walk proceeds —
        # degraded but never deadlocked).
        if unload_gate is not None:
            self.unload_gate = dict(tol_p=0.02, tol_v=0.05, max_extra=1500)
            self.unload_gate.update(unload_gate)
        else:
            self.unload_gate = None
        # CoM servo on the waist TARGET (the decisive piece of the biped
        # 2nd-shift fix). Measured root cause: the pelvis tracks its
        # min-jerk essentially perfectly (cmd == QP == plant acceleration,
        # sub-mm error — instrumented), but the CoM is NOT the pelvis —
        # unactuated upper-body/leg mass lags the transfer by ~6 cm, then
        # catches up with momentum and overshoots the stance foot; the CoP
        # saturates and the stance foot skids sideways. ``com_servo``
        # (a dict of gains; True for defaults) closes a PD+I loop from the
        # MEASURED CoM (position AND velocity) against the script's
        # intended CoM trajectory (LegLiftScript.com_ref_at) into a
        # bounded waist-reference offset: the pelvis target moves wherever
        # it must for the measured CoM to track the plan. The D term is
        # load-bearing phase lead — a pure integrator was measured to
        # AMPLIFY the overshoot (windup: the CoM arrives carrying ~3x the
        # reference velocity and the lagging correction can't unwind).
        # Reference-level CoM feedback through a task channel whose
        # tracking is tight — the torque-control analog of the classic
        # position-controlled-humanoid CoM/pelvis admittance loop.
        if com_servo:
            self.com_servo = dict(kp=1.0, kd=0.4, ki=1.0, max=0.12)
            if isinstance(com_servo, dict):
                self.com_servo.update(com_servo)
        else:
            self.com_servo = None
        self.com_servo_max = float(com_servo_max)
        self._wint = np.zeros(2, np.float64)
        # Re-aim each swing's TOUCHDOWN target at lower-phase entry,
        # RELATIVE to the live support (nominal foot spacing from the
        # support's current position) instead of the stride-start
        # absolute. Measured failure of the absolute target: when the
        # stance sole migrates during single support (the pivot-walk
        # pinned by tests/test_humanoid_walk.py), the world-frame
        # foothold drifts out of leg reach (the foot landed 5 cm short)
        # and the reload finds an unloadable geometry. Relative replant
        # restores the nominal support GEOMETRY and accepts global
        # drift — the thing a walking robot actually controls.
        self.relative_replant = bool(relative_replant)
        self._extra = 0
        self.lift_kw = lift_kw
        self.dt = float(lift_kw.get("dt", 1e-3))
        self.stride_ticks = self.phases.total
        self.shift_ticks_max = int(shift_ticks_max
                                   if shift_ticks_max is not None
                                   else 4 * self.phases.shift)
        self.tail = int(tail)
        # Upper bound on the walk length: with adaptive pacing each stride
        # is at most phases-with-max-shift long; extra ticks are spent in
        # the tail's settled hold. Exact when shift_a_max is None.
        max_stride = (self.stride_ticks if shift_a_max is None
                      else self.stride_ticks - self.phases.shift
                      + self.shift_ticks_max)
        if self.unload_gate is not None:
            max_stride += self.unload_gate["max_extra"]
        self.total = self.n_strides * max_stride + self.tail
        self._script: Optional[LegLiftScript] = None
        self._k = -1
        self._t0 = 0

    def swing_foot(self, k: int) -> str:
        return self.order[k % len(self.order)]

    def _start_stride(self, k: int, state, t0: int) -> None:
        kin = kinematics.fk(self.model, state)
        # Re-anchor each foot reference in x/z at its ACTUAL pose
        # (resetReference semantics, /root/reference/src/ForceAcc.cpp:
        # 157-162: absorbs the previous stride's touchdown error) but PIN
        # the lateral reference at the nominal y: a fully-actual re-anchor
        # ratchets cone-limited stance creep inward (the stance servo never
        # fights drift it has absorbed into its own target) until the
        # support polygon degenerates. With y pinned, stance position tasks
        # continuously push creeping feet back out.
        for c in self.plugin.contact_links:
            key = c + "_cartesian"
            tr = dict(self.refs[key])
            p_act = np.asarray(kin.p[self.model.link_index(c)], np.float64)
            tr["p"] = jnp.asarray(
                [p_act[0], self._y_nom[c], p_act[2]], jnp.float32)
            z6 = jnp.zeros(6, jnp.float32)
            tr["v"] = z6
            tr["a"] = z6
            self.refs[key] = tr
        foot = self.swing_foot(k)
        p0y = float(np.asarray(
            self.refs[foot + "_cartesian"]["p"])[1])
        offset = (self.stride[0],
                  self.stride[1] + (self._y_nom[foot] - p0y))
        phases = self.phases
        if self.shift_a_max is not None:
            # capture-point-aware pacing: re-derive THIS stride's shift
            # duration from the actual CoM -> support-centroid transfer
            # distance (min-jerk peak accel 5.77*D/T^2 <= a_max, peak vel
            # 1.875*D/T <= v_max) — see __init__ docs for the physics.
            sup_xy = np.stack(
                [np.asarray(kin.p[self.model.link_index(c)], np.float64)[:2]
                 for c in self.plugin.contact_links if c != foot])
            com0 = np.asarray(kinematics.com(self.model, kin)[1],
                              np.float64)[:2]
            D = float(np.linalg.norm(sup_xy.mean(axis=0) - com0))
            T = max(np.sqrt(5.77 * D / self.shift_a_max),
                    1.875 * D / self.shift_v_max)
            ticks = int(np.ceil(T / self.dt))
            phases = dataclasses.replace(
                self.phases, shift=int(np.clip(ticks, self.phases.shift,
                                               self.shift_ticks_max)))
        self._script = LegLiftScript(
            self.model, self.plugin, self.refs, self._waist,
            foot, state=state, phases=phases,
            foothold_offset=offset, shift_mode=self.shift_mode,
            **self.lift_kw)
        self._waist = np.asarray(self._script.w1, np.float64)
        self._k = k
        self._t0 = int(t0)
        self._extra = 0

    def _com_settled(self, state):
        """(settled, live support centroid xy) — measured CoM over the
        remaining support and slow (the unload gate's condition). The
        centroid is returned so a pausing gate can RETARGET the servo at
        the support's CURRENT position: the transfer target was derived
        from the stance foot's pose at the stride boundary, and if the
        foot has crept since, holding the stale target deadlocks the gate
        against its own criterion (measured: stride-1 fall with the CoM
        caught between a stale c1 and a 20 cm-moved foot)."""
        kin = kinematics.fk(self.model, state)
        _, com_p = kinematics.com(self.model, kin)
        vel_all = kinematics.link_velocities(self.model, kin, state)
        com_v = kinematics.com_velocity(self.model, kin, state, vel_all)
        sup = np.stack(
            [np.asarray(kin.p[self.model.link_index(c)], np.float64)[:2]
             for c in self._script.support])
        cent = sup.mean(axis=0)
        # gate on the TRANSFER-direction component only: the CoM sits at
        # a permanent anatomical fore/aft offset from the foot ORIGIN
        # (sole frames are at the ankle, the standing CoM centimeters
        # ahead), so a full-norm criterion can never be met and the gate
        # deadlocks at max_extra (measured). The balance-critical error
        # for the unload decision is along the weight-transfer axis.
        c0 = np.asarray(self._script.c0, np.float64)[:2]
        c1 = np.asarray(self._script.c1, np.float64)[:2]
        d = c1 - c0
        n = np.linalg.norm(d)
        d = d / n if n > 1e-6 else np.array([0.0, 1.0])
        err = abs(float(np.dot(cent - np.asarray(com_p, np.float64)[:2],
                               d)))
        spd = abs(float(np.dot(np.asarray(com_v, np.float64)[:2], d)))
        g = self.unload_gate
        # retarget only the transfer component toward the live centroid
        cr = c1 + d * float(np.dot(cent - c1, d))
        return (err <= g["tol_p"] and spd <= g["tol_v"]), cr

    def refs_at(self, i: int, state) -> Dict:
        """Per-tick refs (drive with monotonically increasing ``i``).
        ``state``: the CURRENT (estimated) robot state — consumed only at
        stride boundaries to re-derive geometry. Stride boundaries are
        dynamic (adaptive shift pacing makes stride lengths data-
        dependent); ticks past the last stride hold its settled refs."""
        if self._script is None:
            # no strides to run (n_strides == 0): the base refs are
            # already a settled all-gates-on hold
            if self.n_strides == 0:
                return self.refs
            self._start_stride(0, state, t0=i)
        while (self._k + 1 < self.n_strides
               and i >= self._t0 + self._script.total + self._extra):
            self._start_stride(self._k + 1, state,
                               t0=self._t0 + self._script.total
                               + self._extra)
        j = i - self._t0 - self._extra
        pause_cent = None
        if (self.unload_gate is not None
                and j == self._script.t_unload0
                and self._extra < self.unload_gate["max_extra"]):
            settled, cent = self._com_settled(state)
            if not settled:
                # pause the script clock at the unload boundary: keep
                # emitting the settled pre-unload refs, and RETARGET the
                # CoM servo at the live support centroid (see
                # _com_settled) until the CoM has actually arrived
                self._extra += 1
                j -= 1
                pause_cent = cent
        if self.relative_replant and j == self._script.t_lower0:
            # re-aim the touchdown at nominal spacing from the LIVE
            # support (see __init__) — lateral component only; continuity
            # holds because the lower min-jerk starts exactly at pf_up
            s = self._script
            kin_r = kinematics.fk(self.model, state)
            sup_y = float(np.mean(
                [np.asarray(kin_r.p[self.model.link_index(c)],
                            np.float64)[1] for c in s.support]))
            nom_gap = self._y_nom[s.foot] - float(np.mean(
                [self._y_nom[c] for c in s.support]))
            pf = np.asarray(s.pf_dn, np.float64)
            pf[1] = sup_y + nom_gap
            s.pf_dn = jnp.asarray(pf, jnp.float32)
        jj = min(j, self._script.total - 1)  # tail holds the settled refs
        r = self._script.refs_at(jj)
        if self.com_servo is not None:
            g = self.com_servo
            kin = kinematics.fk(self.model, state)
            _, com_p = kinematics.com(self.model, kin)
            vel_all = kinematics.link_velocities(self.model, kin, state)
            com_v = kinematics.com_velocity(self.model, kin, state,
                                            vel_all)
            cr_p, cr_v = self._script.com_ref_at(jj)
            cr_xy = np.asarray(cr_p, np.float64)[:2]
            if pause_cent is not None:
                cr_xy = pause_cent
            elif jj >= self._script.t_unload0:
                # single-support phases: track the LIVE support centroid
                # (transfer-direction component), not the stride-start
                # absolute. Measured failure of the stale target: the
                # stance foot pivot-walks outboard on its inner patch
                # edge while the servo pins the CoM at old-c1 inboard of
                # it — the CoP stays edge-loaded, the foot keeps walking,
                # and the replant finds an unloadable geometry. With the
                # ref following the foot, the CoP re-centers and the walk
                # self-arrests.
                sup = np.stack([np.asarray(
                    kin.p[self.model.link_index(c)], np.float64)[:2]
                    for c in self._script.support])
                cent = sup.mean(axis=0)
                c0 = np.asarray(self._script.c0, np.float64)[:2]
                c1 = np.asarray(self._script.c1, np.float64)[:2]
                d = c1 - c0
                n = np.linalg.norm(d)
                d = d / n if n > 1e-6 else np.array([0.0, 1.0])
                cr_xy = c1 + d * float(np.dot(cent - c1, d))
            e = cr_xy - np.asarray(com_p, np.float64)[:2]
            edot = np.asarray(cr_v, np.float64)[:2] \
                - np.asarray(com_v, np.float64)[:2]
            self._wint = np.clip(self._wint + g["ki"] * self.dt * e,
                                 -g["max"], g["max"])
            corr = np.clip(g["kp"] * e + g["kd"] * edot + self._wint,
                           -g["max"], g["max"])
            r = dict(r)
            wt = dict(r["waist_task"])
            wt["p"] = wt["p"] + jnp.asarray(np.r_[corr, 0.0], jnp.float32)
            r["waist_task"] = wt
        return r
