"""The port's SHA-256 and UInt32 gadgets (``nova_tpu_torch.frontend.sha256``,
``frontend.uint32``) against the JAX package and ``hashlib`` on CPU, and an
IVC whose step circuit runs UInt32 word ops.

Inputs come from a numpy seed. Tolerance: exact (digests, constraints term
for term, assignments, proof fields; commitments as affine points). The
IVC runs 3 prove_steps: the third replays the port's witness tape, whose
result bits of ``addmany`` read their operands' bits again; the JAX
package's ``addmany`` allocates those bits as trace-time constants, so its
replay breaks (TapeReplayError) and its reference run synthesizes every
step (``tape_safe = False``)."""

import hashlib
import random
import secrets

import numpy as np
import pytest
import torch

from nova_tpu.errors import TapeReplayError as JTapeReplayError
from nova_tpu.frontend.boolean import AllocatedBit as JBit, Boolean as JBool
from nova_tpu.frontend.constraint_system import (
    ONE as JONE,
    LinearCombination as JLC,
    TestConstraintSystem as JTestCS,
    lc as jlc,
)
from nova_tpu.frontend.num import AllocatedNum as JNum
from nova_tpu.frontend.sha256 import sha256 as jsha256
from nova_tpu.frontend.uint32 import MultiEq as JMultiEq, UInt32 as JUInt32
from nova_tpu.nova.circuit import StepCircuit as JStep
from nova_tpu.nova.ivc import RecursiveSNARK as JRS
from nova_tpu.provider.engines import PallasEngine as JPE

from nova_tpu_torch.frontend.boolean import AllocatedBit as TBit, Boolean as TBool
from nova_tpu_torch.frontend.constraint_system import (
    ONE as TONE,
    LinearCombination as TLC,
    TestConstraintSystem as TTestCS,
    lc as tlc,
)
from nova_tpu_torch.frontend.num import AllocatedNum as TNum
from nova_tpu_torch.frontend.sha256 import sha256 as tsha256
from nova_tpu_torch.frontend.uint32 import MultiEq as TMultiEq, UInt32 as TUInt32
from nova_tpu_torch.nova.circuit import StepCircuit as TStep
from nova_tpu_torch.nova.ivc import RecursiveSNARK as TRS
from nova_tpu_torch.ops.fvec import as_list
from nova_tpu_torch.provider.engines import PallasEngine as TPE

from tests.test_torch_ivc import carried, reference_pp

torch.set_num_threads(1)

JAX = {"Bit": JBit, "Bool": JBool, "CS": JTestCS, "sha256": jsha256, "UInt32": JUInt32,
       "MultiEq": JMultiEq, "field": JPE.scalar}
PORT = {"Bit": TBit, "Bool": TBool, "CS": TTestCS, "sha256": tsha256, "UInt32": TUInt32,
        "MultiEq": TMultiEq, "field": TPE.scalar}


def _constraints(cs):
    """A TestConstraintSystem's constraints as (A, B, C) rows of (variable,
    coefficient) terms in the order the linear combinations hold them."""
    def row(lc_):
        return [(tuple(var), coeff) for var, coeff in lc_.iter_terms()]

    return [tuple(row(x) for x in cons) for cons in cs.constraints]


def _digest_of(pkg, msg: bytes):
    cs = pkg["CS"](pkg["field"])
    bits = [pkg["Bool"].from_bit(pkg["Bit"].alloc(cs, bool((byte >> (7 - i)) & 1)))
            for byte in msg for i in range(8)]
    out = pkg["sha256"](cs, bits)
    got = 0
    for b in out:
        got = (got << 1) | (1 if b.get_value() else 0)
    return cs, got


@pytest.mark.parametrize("msg_len", [0, 3, 55, 56, 64, 100])
def test_sha256_matches_hashlib_and_reference(msg_len):
    msg = np.random.default_rng(1000 + msg_len).bytes(msg_len)
    jcs, jgot = _digest_of(JAX, msg)
    tcs, tgot = _digest_of(PORT, msg)
    assert tcs.is_satisfied()
    assert tgot == jgot == int.from_bytes(hashlib.sha256(msg).digest(), "big")
    assert tcs.num_constraints() == jcs.num_constraints()
    assert _constraints(tcs) == _constraints(jcs)
    assert tcs.aux_assignment == jcs.aux_assignment
    assert tcs.input_assignment == jcs.input_assignment


def _word_ops(pkg, vals):
    cs = pkg["CS"](pkg["field"])
    U = pkg["UInt32"]
    a, b, c, d, e = (U.alloc(cs, v) for v in vals)
    outs = {
        "rotr": a.rotr(7), "rotr0": b.rotr(32), "shr": a.shr(3),
        "xor": a.xor(cs, b), "maj": U.sha256_maj(cs, a, b, c),
        "ch": U.sha256_ch(cs, a, b, c),
    }
    with pkg["MultiEq"](cs) as meq:
        outs["addmany2"] = U.addmany(meq, [a, b])
        outs["addmany5"] = U.addmany(meq, [a, b, c, d, e])
        outs["addmany_const"] = U.addmany(meq, [U.constant(vals[0]), U.constant(vals[1])])
    bits = {k: [x.get_value() for x in w.bits] for k, w in outs.items()}
    return cs, {k: w.value for k, w in outs.items()}, bits


def test_uint32_ops_match_reference():
    rng = np.random.default_rng(7)
    vals = [int(v) for v in rng.integers(0, 1 << 32, 5, dtype=np.uint64)]
    vals[4] = 0xFFFFFFFF
    jcs, jv, jb = _word_ops(JAX, vals)
    tcs, tv, tb = _word_ops(PORT, vals)
    a, b, c = vals[:3]
    m = 0xFFFFFFFF
    want = {
        "rotr": ((a >> 7) | (a << 25)) & m, "rotr0": b, "shr": a >> 3, "xor": a ^ b,
        "maj": (a & b) ^ (a & c) ^ (b & c), "ch": (a & b) ^ (~a & c) & m,
        "addmany2": (a + b) & m, "addmany5": sum(vals) & m, "addmany_const": (a + b) & m,
    }
    assert tv == jv == want
    for k, v in want.items():
        assert tb[k] == [bool((v >> i) & 1) for i in range(32)], k
    assert tb == jb
    assert tcs.is_satisfied()
    assert _constraints(tcs) == _constraints(jcs)
    assert tcs.aux_assignment == jcs.aux_assignment


def word_circuit(Step, Bit, Bool, UInt32, MultiEq, Num, ONE, LC, lc, tape_safe=True):
    """z -> a function of z's low 32 bits through rotr, shr, xor, maj, ch
    and addmany; the word's bits are allocated with closures over z, and
    the output is their weighted sum."""

    class Words(Step):
        def arity(self):
            return 1

        def synthesize(self, cs, z):
            x = z[0]

            def bit(i):
                return lambda: None if x.get_value() is None else bool((x.get_value() >> i) & 1)

            w = UInt32.from_bits([Bool.from_bit(Bit.alloc(cs, bit(i))) for i in range(32)])
            k = UInt32.constant(0x9E3779B9)
            s0 = w.rotr(7).xor(cs, w.rotr(18)).xor(cs, w.shr(3))
            maj = UInt32.sha256_maj(cs, w, s0, k)
            ch = UInt32.sha256_ch(cs, s0, w, maj)
            with MultiEq(cs) as meq:
                out = UInt32.addmany(meq, [w, s0, maj, ch, k])
            bits = out.bits

            def val():
                vs = [b.get_value() for b in bits]
                if any(v is None for v in vs):
                    return None
                return sum(1 << i for i, v in enumerate(vs) if v)

            y = Num.alloc(cs, val)
            terms = LC.zero()
            for i, b in enumerate(bits):
                terms = terms + b.lc(ONE, 1 << i)
            cs.enforce(terms, lc((1, ONE)), lc((1, y.get_variable())))
            return [y]

    c = Words()
    c.tape_safe = tape_safe
    return c


def _expected(z: int, steps: int) -> int:
    m = 0xFFFFFFFF

    def rotr(v, r):
        return ((v >> r) | (v << (32 - r))) & m

    k = 0x9E3779B9
    for _ in range(steps):
        w = z & m
        s0 = rotr(w, 7) ^ rotr(w, 18) ^ (w >> 3)
        maj = (w & s0) ^ (w & k) ^ (s0 & k)
        ch = (s0 & w) ^ (~s0 & maj) & m
        z = (w + s0 + maj + ch + k) & m
    return z


def _run(RS, pp, circuit, steps, seed, monkeypatch):
    rnd = random.Random(seed)
    monkeypatch.setattr(secrets, "randbelow", lambda n: rnd.randrange(n))
    rs = RS.new(pp, circuit, [0x12345678])
    for _ in range(steps):
        rs.prove_step(pp, circuit)
    return rs


def _relaxed(U):
    return (U.comm_W.to_coordinates(), U.comm_E.to_coordinates(), list(U.X), U.u)


def test_word_ops_ivc_matches_reference(monkeypatch):
    steps = 3
    jc = word_circuit(JStep, JBit, JBool, JUInt32, JMultiEq, JNum, JONE, JLC, jlc, tape_safe=False)
    tc = word_circuit(TStep, TBit, TBool, TUInt32, TMultiEq, TNum, TONE, TLC, tlc)
    jpp = reference_pp(jc)
    tpp = carried(jpp)
    assert tpp.digest() == jpp.digest()
    j = _run(JRS, jpp, jc, steps, 23, monkeypatch)
    t = _run(TRS, tpp, tc, steps, 23, monkeypatch)
    # the port's third step replayed its tape; the reference synthesized it
    assert t._wgen_primary is not None and j._wgen_primary is None
    assert t.i == j.i == steps and t.zi == j.zi == [_expected(0x12345678, steps)]
    for name in ("r_U_primary", "r_U_secondary"):
        assert _relaxed(getattr(t, name)) == _relaxed(getattr(j, name)), name
    for name in ("r_W_primary", "r_W_secondary"):
        tw, jw = getattr(t, name), getattr(j, name)
        assert as_list(tw.W) == list(jw.W) and as_list(tw.E) == list(jw.E), name
        assert (tw.r_W, tw.r_E) == (jw.r_W, jw.r_E), name
    assert t.verify(tpp, steps, [0x12345678]) == j.verify(jpp, steps, [0x12345678])
    # the reference's own tape replays addmany's bits as trace-time constants
    jt = word_circuit(JStep, JBit, JBool, JUInt32, JMultiEq, JNum, JONE, JLC, jlc)
    with pytest.raises(JTapeReplayError):
        _run(JRS, jpp, jt, steps, 23, monkeypatch)
