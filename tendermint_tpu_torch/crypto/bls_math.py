"""Pure-Python BLS12-381: fields, curves, pairing, and the signature
scheme behind the aggregate-commit path (the port's copy of
tendermint_tpu/crypto/bls_math.py). crypto/bls.py wraps this with the
PubKey/PrivKey interface; crypto/cuda/bls_pairing.py is the batched
sibling on the card and consumes `prepare_lines` from here, so both
paths run the *same* Miller-loop line schedule.

Like softcrypto.py, this module is load-bearing: the container has no
`py_ecc`/`blst`, so every BLS verification a node performs can land
here. The formulations are chosen to be verifiable by construction:

  * Fq12 is the FLAT representation Fq2[w]/(w^6 - xi), xi = 1 + u — one
    schoolbook polynomial multiply with an xi-fold instead of the
    2-3-2 tower, which makes `f12_mul` a single tight function over
    12-int tuples (lazy reduction: one mod per output coefficient).
  * The Miller loop is affine with per-step Fq2 inversions (a 381-bit
    Fermat inversion costs ~30 us in CPython — cheaper than carrying
    projective formulas we would have to transcribe on trust). Line
    coefficients are precomputed per G2 point (`prepare_lines`, the
    G2Prepared idiom) so the device kernels can consume them as tensors.
  * The final-exponentiation hard part is a plain square-and-multiply
    by the integer (p^4 - p^2 + 1)/r — slower than the cyclotomic
    addition chains but correct by construction.
  * Tower/Frobenius constants and the G2 cofactor are DERIVED at import
    from (p, r, x) and cross-checked (trace identities, twist-order
    candidates, eta = -1), not transcribed from papers.

Hash-to-curve: `expand_message_xmd` and `hash_to_field` follow RFC 9380
exactly; the curve map is a framework-defined try-and-increment map
(deterministic, constant-free), NOT the SSWU ciphersuite — no
cross-implementation signature interop is claimed (same stance as
sr25519's key expansion). Signatures are min-pubkey-size: pubkeys in G1
(48 B compressed), signatures in G2 (96 B compressed), aggregation is
plain G2 point addition so anyone can aggregate after the fact.
"""

from __future__ import annotations

import hashlib
import math

# -- base field / curve constants -------------------------------------------

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
X_PARAM = -0xD201000000010000  # the (negative) BLS12 parameter
_ABS_X = -X_PARAM
X_BITS = bin(_ABS_X)[2:]  # MSB-first bit string of |x|

B1 = 4  # E : y^2 = x^3 + 4 over Fq
B2 = (4, 4)  # E': y^2 = x^3 + 4(1+u) over Fq2 (the sextic twist)

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# import-time sanity: the hardcoded generators must sit on their curves
# (cheap int math; order/pairing checks live in tests/test_bls.py)
assert (G1_GEN[1] ** 2 - G1_GEN[0] ** 3 - B1) % P == 0, "G1 generator off-curve"

# -- Fq2 = Fq[u]/(u^2 + 1) ---------------------------------------------------

XI = (1, 1)  # the sextic non-residue 1 + u


def q2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def q2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def q2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def q2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def q2_sqr(a):
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def q2_smul(k, a):
    return (k * a[0] % P, k * a[1] % P)


def q2_inv(a):
    a0, a1 = a
    n = pow(a0 * a0 + a1 * a1, P - 2, P)
    return (a0 * n % P, (-a1) * n % P)


def q2_pow(a, e: int):
    out = (1, 0)
    base = a
    while e:
        if e & 1:
            out = q2_mul(out, base)
        base = q2_sqr(base)
        e >>= 1
    return out


def q2_sqrt(a):
    """Square root in Fq2 for p = 3 mod 4 via the norm trick; returns
    None for non-residues. Result is re-verified, so a wrong branch can
    only return None, never a bad root."""
    a0, a1 = a
    if a1 == 0:
        c = pow(a0, (P + 1) // 4, P)
        if c * c % P == a0:
            return (c, 0)
        c = pow((-a0) % P, (P + 1) // 4, P)
        if c * c % P == (-a0) % P:
            return (0, c)  # (c*u)^2 = -c^2 = a0
        return None
    norm = (a0 * a0 + a1 * a1) % P
    alpha = pow(norm, (P + 1) // 4, P)
    if alpha * alpha % P != norm:
        return None
    for delta in ((a0 + alpha) * INV2 % P, (a0 - alpha) * INV2 % P):
        x0 = pow(delta, (P + 1) // 4, P)
        if x0 * x0 % P != delta:
            continue
        if x0 == 0:
            continue
        x1 = a1 * pow(2 * x0 % P, P - 2, P) % P
        if (x0 * x0 - x1 * x1) % P == a0 and 2 * x0 * x1 % P == a1:
            return (x0, x1)
    return None

assert q2_sub(q2_sqr(G2_GEN[1]), q2_mul(q2_sqr(G2_GEN[0]), G2_GEN[0])) == B2, (
    "G2 generator off-curve"
)

XI_INV = q2_inv(XI)
INV2 = pow(2, P - 2, P)

# -- derived tower/cofactor constants (computed, not transcribed) ------------

# Frobenius^2 on the flat Fq12 rep: w^(p^2) = w * zeta with
# zeta = xi^((p^2-1)/6); zeta is a 6th root of unity, hence in Fq.
_zeta2 = q2_pow(XI, (P * P - 1) // 6)
assert _zeta2[1] == 0, "zeta not in Fq — tower constant derivation broken"
ZETA = _zeta2[0]
FROB2_COEFFS = tuple(pow(ZETA, i, P) for i in range(6))

# Frobenius^6 (conjugation): eta = xi^((p^6-1)/6) must be exactly -1
_eta = q2_pow(XI, (P**6 - 1) // 6)
assert _eta == (P - 1, 0), "eta != -1 — flat-tower conjugation broken"

# final-exponentiation hard part
assert (P**4 - P**2 + 1) % R == 0
HARD_EXP = (P**4 - P**2 + 1) // R
HARD_BITS = bin(HARD_EXP)[2:]

# G1 cofactor from the BLS12 trace identity t = x + 1
_TRACE = X_PARAM + 1
assert (P + 1 - _TRACE) % R == 0, "G1 order not divisible by r"
H1_COFACTOR = (P + 1 - _TRACE) // R
assert H1_COFACTOR == (X_PARAM - 1) ** 2 // 3  # the textbook h1 = (x-1)^2/3


def _derive_h2() -> int:
    """G2 cofactor = #E'(Fq2)/r, derived from the sextic-twist order
    candidates: with t2 = t^2 - 2p (Frobenius trace over Fq2) and f2
    from t2^2 - 4p^2 = -3 f2^2, the six twist orders are p^2 + 1 - c,
    c in {±t2, ±(t2±3f2)/2}; exactly one is divisible by r."""
    t2 = _TRACE * _TRACE - 2 * P
    d = 4 * P * P - t2 * t2
    assert d % 3 == 0
    f2 = math.isqrt(d // 3)
    assert 3 * f2 * f2 == d, "twist discriminant not -3*square"
    cands = {t2, -t2}
    for s in (t2 + 3 * f2, t2 - 3 * f2):
        assert s % 2 == 0
        cands.update((s // 2, -s // 2))
    hits = [c for c in cands if (P * P + 1 - c) % R == 0]
    # both sextic twists can have r-divisible order; disambiguate with a
    # cheap point on OUR twist: its order must annihilate every point
    if len(hits) > 1:
        q = None
        x = (1, 0)
        while q is None:
            y = q2_sqrt(q2_add(q2_mul(q2_sqr(x), x), B2))
            if y is not None:
                q = (x, y)
            else:
                x = q2_add(x, (1, 0))
        hits = [c for c in hits if _jmul(q, P * P + 1 - c, _FQ2) is None]
    assert len(hits) == 1, f"ambiguous twist order candidates: {hits}"
    return (P * P + 1 - hits[0]) // R


# (the derivation needs the curve arithmetic below; assigned after it)

# -- Fq12 (flat): tuples of 12 ints, coefficient i of w^i = (f[2i], f[2i+1]) -

F12_ONE = (1,) + (0,) * 11
F12_ZERO = (0,) * 12


def f12_mul(a, b):
    """Schoolbook degree-6 polynomial product over Fq2 with the w^6 = xi
    fold; lazy reduction (one mod per output coefficient). Zero
    coefficients of `a` short-circuit, so passing the sparse operand
    (e.g. a Miller line: coefficients 0/3/5 only) FIRST costs 18 inner
    products instead of 36."""
    ar = [0] * 11
    ai = [0] * 11
    for i in range(6):
        x0 = a[2 * i]
        x1 = a[2 * i + 1]
        if x0 == 0 and x1 == 0:
            continue
        for j in range(6):
            y0 = b[2 * j]
            y1 = b[2 * j + 1]
            k = i + j
            ar[k] += x0 * y0 - x1 * y1
            ai[k] += x0 * y1 + x1 * y0
    out = []
    for k in range(6):
        re = ar[k]
        im = ai[k]
        if k + 6 <= 10:
            hr = ar[k + 6]
            hi = ai[k + 6]
            re += hr - hi  # * xi = (1 + u): (r + iu)(1+u) = (r - i) + (r + i)u
            im += hr + hi
        out.append(re % P)
        out.append(im % P)
    return tuple(out)


def f12_sqr(a):
    """Dedicated squaring: 21 Fq2 products instead of 36 (the final-exp
    hard part is squaring-dominated, ~1270 of these per pairing)."""
    ar = [0] * 11
    ai = [0] * 11
    for i in range(6):
        x0 = a[2 * i]
        x1 = a[2 * i + 1]
        if x0 == 0 and x1 == 0:
            continue
        ar[2 * i] += x0 * x0 - x1 * x1
        ai[2 * i] += 2 * x0 * x1
        for j in range(i + 1, 6):
            y0 = a[2 * j]
            y1 = a[2 * j + 1]
            k = i + j
            ar[k] += 2 * (x0 * y0 - x1 * y1)
            ai[k] += 2 * (x0 * y1 + x1 * y0)
    out = []
    for k in range(6):
        re = ar[k]
        im = ai[k]
        if k + 6 <= 10:
            hr = ar[k + 6]
            hi = ai[k + 6]
            re += hr - hi
            im += hr + hi
        out.append(re % P)
        out.append(im % P)
    return tuple(out)


def f12_conj(a):
    """f^(p^6): negate the odd-w coefficients (eta = -1, asserted above)."""
    out = list(a)
    for i in (1, 3, 5):
        out[2 * i] = (-out[2 * i]) % P
        out[2 * i + 1] = (-out[2 * i + 1]) % P
    return tuple(out)


def f12_frob2(a):
    """f^(p^2): Fq2 coefficients are fixed, w^i picks up zeta^i in Fq."""
    out = []
    for i in range(6):
        z = FROB2_COEFFS[i]
        out.append(a[2 * i] * z % P)
        out.append(a[2 * i + 1] * z % P)
    return tuple(out)


def f12_inv(a):
    """Norm-based inversion: g = prod of the five Frobenius^2 conjugates,
    f*g lands in Fq2 (its w^1..w^5 coefficients vanish), one Fq2
    inversion finishes."""
    g = f12_frob2(a)
    acc = g
    for _ in range(4):
        g = f12_frob2(g)
        acc = f12_mul(acc, g)
    n = f12_mul(a, acc)
    n_inv = q2_inv((n[0], n[1]))
    out = []
    for i in range(6):
        c = q2_mul((acc[2 * i], acc[2 * i + 1]), n_inv)
        out.extend(c)
    return tuple(out)


def f12_pow(a, bits: str):
    out = F12_ONE
    for b in bits:
        out = f12_sqr(out)
        if b == "1":
            out = f12_mul(out, a)
    return out


# -- curve arithmetic (generic Jacobian over a field namespace) --------------


class _FQ:
    add = staticmethod(lambda a, b: (a + b) % P)
    sub = staticmethod(lambda a, b: (a - b) % P)
    mul = staticmethod(lambda a, b: a * b % P)
    sqr = staticmethod(lambda a: a * a % P)
    smul = staticmethod(lambda k, a: k * a % P)
    inv = staticmethod(lambda a: pow(a, P - 2, P))
    zero = 0
    one = 1


class _FQ2:
    add = staticmethod(q2_add)
    sub = staticmethod(q2_sub)
    mul = staticmethod(q2_mul)
    sqr = staticmethod(q2_sqr)
    smul = staticmethod(q2_smul)
    inv = staticmethod(q2_inv)
    zero = (0, 0)
    one = (1, 0)


def _jdbl(pt, F):
    X, Y, Z = pt
    if Z == F.zero or Y == F.zero:
        return (F.one, F.one, F.zero)
    A = F.sqr(X)
    Bv = F.sqr(Y)
    C = F.sqr(Bv)
    D = F.smul(2, F.sub(F.sub(F.sqr(F.add(X, Bv)), A), C))
    E = F.smul(3, A)
    Fv = F.sqr(E)
    X3 = F.sub(Fv, F.smul(2, D))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.smul(8, C))
    Z3 = F.smul(2, F.mul(Y, Z))
    return (X3, Y3, Z3)


def _jadd_mixed(pt, q_affine, F):
    """Jacobian + affine (madd-2007-bl shape with doubling/inf handling)."""
    X1, Y1, Z1 = pt
    X2, Y2 = q_affine
    if Z1 == F.zero:
        return (X2, Y2, F.one)
    Z1Z1 = F.sqr(Z1)
    U2 = F.mul(X2, Z1Z1)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H = F.sub(U2, X1)
    r = F.smul(2, F.sub(S2, Y1))
    if H == F.zero:
        if r == F.zero:
            return _jdbl(pt, F)
        return (F.one, F.one, F.zero)  # P + (-P)
    HH = F.sqr(H)
    Iv = F.smul(4, HH)
    J = F.mul(H, Iv)
    V = F.mul(X1, Iv)
    X3 = F.sub(F.sub(F.sqr(r), J), F.smul(2, V))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.smul(2, F.mul(Y1, J)))
    Z3 = F.sub(F.sub(F.sqr(F.add(Z1, H)), Z1Z1), HH)
    return (X3, Y3, Z3)


def _jmul(q_affine, k: int, F):
    """k * Q, affine in/out (None = infinity), double-and-add MSB-first."""
    if q_affine is None:
        return None
    if k < 0:
        q_affine = (q_affine[0], F.sub(F.zero, q_affine[1]))
        k = -k
    if k == 0:
        return None
    acc = (F.one, F.one, F.zero)
    for b in bin(k)[2:]:
        acc = _jdbl(acc, F)
        if b == "1":
            acc = _jadd_mixed(acc, q_affine, F)
    return _to_affine(acc, F)


def _to_affine(pt, F):
    X, Y, Z = pt
    if Z == F.zero:
        return None
    zi = F.inv(Z)
    zi2 = F.sqr(zi)
    return (F.mul(X, zi2), F.mul(Y, F.mul(zi, zi2)))


def _affine_add(p, q, F, b_coeff):
    """Affine point addition (None = infinity) — used where we only ever
    add two points once (hash-to-curve), so Jacobian buys nothing."""
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0]:
        if F.add(p[1], q[1]) == F.zero:
            return None
        lam = F.mul(F.smul(3, F.sqr(p[0])), F.inv(F.smul(2, p[1])))
    else:
        lam = F.mul(F.sub(q[1], p[1]), F.inv(F.sub(q[0], p[0])))
    x3 = F.sub(F.sub(F.sqr(lam), p[0]), q[0])
    return (x3, F.sub(F.mul(lam, F.sub(p[0], x3)), p[1]))


def g1_mul(p, k: int):
    return _jmul(p, k, _FQ)


def g2_mul(q, k: int):
    return _jmul(q, k, _FQ2)


def g2_add(p, q):
    return _affine_add(p, q, _FQ2, B2)


def g1_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - B1) % P == 0


def g2_on_curve(q) -> bool:
    if q is None:
        return True
    x, y = q
    return q2_sub(q2_sqr(y), q2_mul(q2_sqr(x), x)) == B2


def g1_in_subgroup(p) -> bool:
    return g1_on_curve(p) and g1_mul(p, R) is None


def g2_in_subgroup(q) -> bool:
    return g2_on_curve(q) and g2_mul(q, R) is None


H2_COFACTOR = _derive_h2()


# -- pairing -----------------------------------------------------------------


def prepare_lines(q) -> list:
    """Per-step Miller line coefficients for a fixed G2 point (affine,
    on the twist). Each entry is (a5, c3), both Fq2: the line through
    the current T evaluated at P=(px,py) in G1 is, in the flat Fq12 rep,

        l(P) = py * w^0  +  c3 * w^3  +  (a5 * px) * w^5

    with a5 = -lambda * xi^-1 and c3 = (lambda*Tx - Ty) * xi^-1 (the
    D-type untwist x = x' w^-2, y = y' w^-3, w^-1 = w^5 xi^-1). The
    schedule is one doubling line per bit of |x| after the leading one,
    plus an addition line on set bits — identical for the device kernels,
    which consume these same tuples as limb tensors."""
    qx, qy = q
    tx, ty = qx, qy
    lines = []

    def emit(lam):
        a5 = q2_neg(q2_mul(lam, XI_INV))
        c3 = q2_mul(q2_sub(q2_mul(lam, tx), ty), XI_INV)
        lines.append((a5, c3))

    for bit in X_BITS[1:]:
        lam = q2_mul(q2_smul(3, q2_sqr(tx)), q2_inv(q2_smul(2, ty)))
        emit(lam)
        x3 = q2_sub(q2_sqr(lam), q2_smul(2, tx))
        ty = q2_sub(q2_mul(lam, q2_sub(tx, x3)), ty)
        tx = x3
        if bit == "1":
            lam = q2_mul(q2_sub(qy, ty), q2_inv(q2_sub(qx, tx)))
            emit(lam)
            x3 = q2_sub(q2_sub(q2_sqr(lam), tx), qx)
            ty = q2_sub(q2_mul(lam, q2_sub(tx, x3)), ty)
            tx = x3
    return lines


def _line_f12(line, px: int, py: int):
    a5, c3 = line
    return (
        py, 0, 0, 0, 0, 0,
        c3[0], c3[1], 0, 0,
        a5[0] * px % P, a5[1] * px % P,
    )


def miller_loop(p, lines) -> tuple:
    """Miller function f_{|x|,Q}(P) from precomputed lines; the final
    conjugation accounts for the negative BLS parameter."""
    px, py = p
    f = F12_ONE
    idx = 0
    for bit in X_BITS[1:]:
        f = f12_sqr(f)
        f = f12_mul(_line_f12(lines[idx], px, py), f)
        idx += 1
        if bit == "1":
            f = f12_mul(_line_f12(lines[idx], px, py), f)
            idx += 1
    return f12_conj(f)


def final_exp(f) -> tuple:
    f1 = f12_mul(f12_conj(f), f12_inv(f))  # ^(p^6 - 1)
    f2 = f12_mul(f12_frob2(f1), f1)  # ^(p^2 + 1)
    return f12_pow(f2, HARD_BITS)  # ^((p^4 - p^2 + 1)/r)


def multi_pairing(pairs) -> tuple:
    """prod_i e(P_i, Q_i): one Miller product, ONE final exponentiation —
    the aggregate-verify shape (n+1 pairings cost n+1 Miller loops but a
    single hard-part exponentiation)."""
    f = F12_ONE
    for p, q in pairs:
        if p is None or q is None:
            continue  # e(O, Q) = e(P, O) = 1
        f = f12_mul(f, miller_loop(p, prepare_lines(q)))
    return final_exp(f)


def pairing(p, q) -> tuple:
    return multi_pairing([(p, q)])


# -- hash to G2 --------------------------------------------------------------

DST_SIG = b"TMTPU-BLS12381-SIG:SHA256-FWMAP-V1"
DST_POP = b"TMTPU-BLS12381-POP:SHA256-FWMAP-V1"


def _sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def expand_message_xmd(msg: bytes, dst: bytes, length: int) -> bytes:
    """RFC 9380 §5.3.1 with SHA-256 (exact, pinned against the RFC's
    published expander vectors in tests/test_bls.py)."""
    if len(dst) > 255:
        dst = _sha256(b"H2C-OVERSIZE-DST-" + dst)
    ell = (length + 31) // 32
    if ell > 255 or length > 65535:
        raise ValueError("expand_message_xmd: output too long")
    dst_prime = dst + bytes([len(dst)])
    b0 = _sha256(b"\x00" * 64 + msg + length.to_bytes(2, "big") + b"\x00" + dst_prime)
    blocks = [_sha256(b0 + b"\x01" + dst_prime)]
    for i in range(2, ell + 1):
        blocks.append(
            _sha256(bytes(x ^ y for x, y in zip(b0, blocks[-1])) + bytes([i]) + dst_prime)
        )
    return b"".join(blocks)[:length]


def hash_to_field_fq2(msg: bytes, dst: bytes, count: int = 2) -> list:
    """RFC 9380 §5.2 hash_to_field for Fq2 (m=2, L=64)."""
    L = 64
    u = expand_message_xmd(msg, dst, count * 2 * L)
    out = []
    for i in range(count):
        c = []
        for j in range(2):
            off = L * (j + i * 2)
            c.append(int.from_bytes(u[off : off + L], "big") % P)
        out.append(tuple(c))
    return out




def _sgn0_fq2(a) -> int:
    """RFC 9380 sgn0 for m=2."""
    return (a[0] & 1) | ((a[0] == 0) & (a[1] & 1))


def _map_to_g2(u):
    """Framework-defined deterministic map: walk x = u, u+1, u+2, ...
    until x^3 + 4(1+u) is square, pick the root whose sgn0 matches u's.
    Constant-free and easy to audit; NOT the RFC SSWU ciphersuite map
    (documented in the module docstring and README)."""
    x = u
    while True:
        y2 = q2_add(q2_mul(q2_sqr(x), x), B2)
        y = q2_sqrt(y2)
        if y is not None:
            break
        x = q2_add(x, (1, 0))
    if _sgn0_fq2(y) != _sgn0_fq2(u):
        y = q2_neg(y)
    return (x, y)


_H2_MEMO: dict = {}
_H2_MEMO_MAX = 4096


def hash_to_point_g2(msg: bytes, dst: bytes = DST_SIG):
    """msg -> G2 subgroup point (hash_to_field with count=2, map both,
    add, clear the cofactor). Memoized: commit messages are re-verified
    across subsystems and gossip rounds."""
    key = (dst, bytes(msg))
    hit = _H2_MEMO.get(key)
    if hit is not None:
        return hit
    u0, u1 = hash_to_field_fq2(msg, dst)
    s = g2_add(_map_to_g2(u0), _map_to_g2(u1))
    if s is None:  # astronomically unlikely; stay deterministic
        s = _map_to_g2(u0)
    pt = g2_mul(s, H2_COFACTOR)
    if len(_H2_MEMO) >= _H2_MEMO_MAX:
        _H2_MEMO.clear()
    _H2_MEMO[key] = pt
    return pt


# -- point serialization (48/96-byte compressed; framework-defined flags) ----

_FLAG_COMPRESSED = 0x80
_FLAG_INFINITY = 0x40
_FLAG_SIGN = 0x20


def _fq_sign(y: int) -> int:
    return 1 if y > P - y else 0


def _fq2_sign(y) -> int:
    return 1 if (y[1], y[0]) > ((P - y[1]) % P, (P - y[0]) % P) else 0


def g1_compress(p) -> bytes:
    if p is None:
        return bytes([_FLAG_COMPRESSED | _FLAG_INFINITY]) + b"\x00" * 47
    x, y = p
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= _FLAG_COMPRESSED | (_FLAG_SIGN if _fq_sign(y) else 0)
    return bytes(out)


def g1_decompress(b: bytes):
    """48-byte compressed -> affine point (None for infinity). Raises
    ValueError on malformed encodings; subgroup membership is NOT
    checked here (g1_in_subgroup — cached by crypto/bls.py)."""
    if len(b) != 48 or not b[0] & _FLAG_COMPRESSED:
        raise ValueError("bad G1 encoding")
    if b[0] & _FLAG_INFINITY:
        if any(b[1:]) or b[0] & ~(_FLAG_COMPRESSED | _FLAG_INFINITY):
            raise ValueError("bad G1 infinity encoding")
        return None
    x = int.from_bytes(b, "big") & ((1 << 381) - 1)
    if x >= P:
        raise ValueError("G1 x out of range")
    y2 = (x * x * x + B1) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise ValueError("G1 x not on curve")
    if _fq_sign(y) != (1 if b[0] & _FLAG_SIGN else 0):
        y = P - y
    return (x, y)


def g2_compress(q) -> bytes:
    if q is None:
        return bytes([_FLAG_COMPRESSED | _FLAG_INFINITY]) + b"\x00" * 95
    (x0, x1), y = q
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= _FLAG_COMPRESSED | (_FLAG_SIGN if _fq2_sign(y) else 0)
    return bytes(out)


def g2_decompress(b: bytes):
    if len(b) != 96 or not b[0] & _FLAG_COMPRESSED:
        raise ValueError("bad G2 encoding")
    if b[0] & _FLAG_INFINITY:
        if any(b[1:]) or b[0] & ~(_FLAG_COMPRESSED | _FLAG_INFINITY):
            raise ValueError("bad G2 infinity encoding")
        return None
    x1 = int.from_bytes(b[:48], "big") & ((1 << 381) - 1)
    x0 = int.from_bytes(b[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x out of range")
    x = (x0, x1)
    y = q2_sqrt(q2_add(q2_mul(q2_sqr(x), x), B2))
    if y is None:
        raise ValueError("G2 x not on curve")
    if _fq2_sign(y) != (1 if b[0] & _FLAG_SIGN else 0):
        y = q2_neg(y)
    return (x, y)


# -- signatures (min-pubkey-size: pk in G1, sig in G2) -----------------------

#: -g1 generator — the fixed first pairing argument of every
#: signature verification; shared by the kernel paths (consensus-
#: critical: both paths must use the identical point)
NEG_G1_GEN = (G1_GEN[0], P - G1_GEN[1])


def keygen(seed: bytes) -> int:
    """Deterministic framework-defined scalar derivation (two SHA-256
    blocks -> 512 bits mod r kills the mod bias)."""
    wide = _sha256(b"TMTPU-BLS-KEYGEN-0" + seed) + _sha256(b"TMTPU-BLS-KEYGEN-1" + seed)
    sk = int.from_bytes(wide, "big") % R
    return sk if sk else 1


def sk_to_pk(sk: int):
    return g1_mul(G1_GEN, sk)


def sign(sk: int, msg: bytes, dst: bytes = DST_SIG):
    return g2_mul(hash_to_point_g2(msg, dst), sk)


def verify(pk, msg: bytes, sig, dst: bytes = DST_SIG) -> bool:
    """Point-level verify: e(-g1, sig) * e(pk, H(m)) == 1. Callers are
    responsible for subgroup-checking pk and sig (crypto/bls.py caches
    both)."""
    if pk is None or sig is None:
        return False
    f = multi_pairing([(NEG_G1_GEN, sig), (pk, hash_to_point_g2(msg, dst))])
    return f == F12_ONE


def aggregate(sigs) -> object:
    """Plain G2 sum — public aggregation, order-independent."""
    acc = None
    for s in sigs:
        acc = g2_add(acc, s)
    return acc


def aggregate_verify(pks, msgs, agg_sig, dst: bytes = DST_SIG) -> bool:
    """Distinct-message aggregate verify:
    e(-g1, agg) * prod_i e(pk_i, H(m_i)) == 1. One Miller loop per
    signer plus one for the aggregate, a single final exponentiation."""
    if agg_sig is None or len(pks) != len(msgs) or not pks:
        return False
    if any(pk is None for pk in pks):
        return False
    pairs = [(NEG_G1_GEN, agg_sig)]
    for pk, msg in zip(pks, msgs):
        pairs.append((pk, hash_to_point_g2(msg, dst)))
    return multi_pairing(pairs) == F12_ONE
