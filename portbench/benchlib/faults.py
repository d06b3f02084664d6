"""Faults planted in the program for the control and the fault tests. Each
is a context manager that patches one function of the program and restores
it on exit; run with one, a cell must come out not correct.

- ``truncated``: the control. Every commitment takes its scalars' low 128
  bits only (the width of Nova's challenges), the step that would tempt a
  faster MSM; a configuration states full-width binding commitments.
- ``state_unchanged``: prove_step returns and leaves the IVC state as it was.
- ``witness_altered``: one entry of every new witness is changed where the
  witness is made, before it is committed.
- ``half_batch``: a device MSM leaves out the second half of its scalars.
- ``point_altered``: a commitment's point is doubled where it is made."""

from __future__ import annotations

import contextlib

MASK128 = (1 << 128) - 1


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = obj.__dict__[name]
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _truncate(v):
    import numpy as np

    from nova_tpu_torch.ops.fvec import FVec, HVec

    if isinstance(v, FVec):
        std = v.tf.from_mont(v.m)
        std[:, 8:] = 0
        return FVec(v.tf, v.tf.to_mont(std))
    if isinstance(v, HVec):
        limbs = np.array(v.limbs64(), copy=True)
        limbs[:, 2:] = 0
        return HVec(v.p, limbs=limbs)
    return [int(x) & MASK128 for x in v]


@contextlib.contextmanager
def truncated():
    import numpy as np

    from nova_tpu_torch.provider.pedersen import CommitmentEngine as CE

    commit, commit_limbs = CE.commit, CE.commit_limbs

    def low_commit(ck, v, r=0):
        return commit(ck, _truncate(v), r)

    def low_commit_limbs(ck, vl, r=0):
        vl = np.array(vl, copy=True)
        vl[:, 2:] = 0
        return commit_limbs(ck, vl, r)

    with _patched(CE, "commit", staticmethod(low_commit)), \
            _patched(CE, "commit_limbs", staticmethod(low_commit_limbs)):
        yield


@contextlib.contextmanager
def state_unchanged():
    from nova_tpu_torch.nova.ivc import RecursiveSNARK

    with _patched(RecursiveSNARK, "prove_step", lambda self, pp, c: None):
        yield


@contextlib.contextmanager
def witness_altered():
    from nova_tpu_torch.r1cs import R1CSWitness

    new = R1CSWitness.new

    def altered(S, W, r_W=None):
        w = new(S, W, r_W)
        i = len(w.W) // 2
        w.W[i] = (w.W[i] + 1) % S.field.p
        return w

    with _patched(R1CSWitness, "new", staticmethod(altered)):
        yield


@contextlib.contextmanager
def half_batch():
    from nova_tpu_torch.ops import msm3

    full = msm3.msm_device3_mont

    def half(marr, device_bases, *a, **k):
        return full(marr[: int(marr.shape[0]) // 2], device_bases, *a, **k)

    with _patched(msm3, "msm_device3_mont", half):
        yield


@contextlib.contextmanager
def point_altered():
    from nova_tpu_torch.provider.pedersen import CommitmentEngine as CE
    from nova_tpu_torch.provider.pedersen import Commitment

    commit = CE.commit

    def doubled(ck, v, r=0):
        C = commit(ck, v, r)
        return Commitment(C.point.add(C.point))

    with _patched(CE, "commit", staticmethod(doubled)):
        yield


FAULTS = {"truncated": truncated, "state_unchanged": state_unchanged,
          "witness_altered": witness_altered, "half_batch": half_batch,
          "point_altered": point_altered}
