"""Exact SILK fixed-point primitives (RFC 6716 reference macro
semantics, portable-C variants — the ones the x86-64 libopus build
compiles).  All functions take/return Python ints interpreted as
opus_int32 unless noted; ops marked _ovflw wrap mod 2^32 like the
reference's intentionally-overflowing macros."""

from __future__ import annotations

_M32 = 0xFFFFFFFF
I32_MAX = 0x7FFFFFFF
I32_MIN = -0x80000000


def wrap32(x: int) -> int:
    x &= _M32
    return x - (1 << 32) if x >= (1 << 31) else x


def sat16(x: int) -> int:
    return 32767 if x > 32767 else (-32768 if x < -32768 else x)


def sat32(x: int) -> int:
    return I32_MAX if x > I32_MAX else (I32_MIN if x < I32_MIN else x)


def to_i16(x: int) -> int:
    x &= 0xFFFF
    return x - 0x10000 if x >= 0x8000 else x


def smulbb(a: int, b: int) -> int:
    return to_i16(a) * to_i16(b)


def smlabb(a: int, b: int, c: int) -> int:
    return a + smulbb(b, c)


def smulwb(a: int, b: int) -> int:
    """((a >> 16) * (int16)b) + (((a & 0xFFFF) * (int16)b) >> 16)."""
    b16 = to_i16(b)
    return (a >> 16) * b16 + (((a & 0xFFFF) * b16) >> 16)


def smlawb(a: int, b: int, c: int) -> int:
    return a + smulwb(b, c)





def smmul(a: int, b: int) -> int:
    return (a * b) >> 32


def smulww(a: int, b: int) -> int:
    """silk_MLA(silk_SMULWB(a, b), a, silk_RSHIFT_ROUND(b, 16))."""
    return smulwb(a, b) + a * rshift_round(b, 16)


def smlaww(a: int, b: int, c: int) -> int:
    return a + smulww(b, c)


def rshift_round(a: int, shift: int) -> int:
    if shift == 1:
        return (a >> 1) + (a & 1)
    return ((a >> (shift - 1)) + 1) >> 1


def rshift_round64(a: int, shift: int) -> int:
    return ((a >> (shift - 1)) + 1) >> 1


def add_sat32(a: int, b: int) -> int:
    return sat32(a + b)


def sub_sat32(a: int, b: int) -> int:
    return sat32(a - b)


def lshift_sat32(a: int, shift: int) -> int:
    """silk_LSHIFT_SAT32: clamp to (INT32_MIN>>shift, INT32_MAX>>shift)
    BEFORE shifting, so positive saturation is (INT32_MAX>>shift)<<shift
    (e.g. 0x7FFFFFF0 for shift 4), exactly as libopus."""
    a = max(I32_MIN >> shift, min(I32_MAX >> shift, a))
    return a << shift


def add32_ovflw(a: int, b: int) -> int:
    return wrap32(a + b)


def sub32_ovflw(a: int, b: int) -> int:
    return wrap32(a - b)


def lshift_ovflw(a: int, shift: int) -> int:
    return wrap32(a << shift)


def clz32(x: int) -> int:
    if x == 0:
        return 32
    return 32 - (x & _M32).bit_length()


def silk_abs(x: int) -> int:
    return -x if x < 0 else x


def silk_rand(seed: int) -> int:
    """RAND(seed) = 907633515 + seed * 196314165 (mod 2^32)."""
    return wrap32(907633515 + wrap32(seed * 196314165))


def div32_16(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q



def inverse32_varQ(b32: int, qres: int) -> int:
    """silk_INVERSE32_varQ — (1 << qres) / b32 with two Newton steps."""
    b_headrm = clz32(silk_abs(b32)) - 1
    b32_nrm = wrap32(b32 << b_headrm)
    b32_inv = div32_16(I32_MAX >> 2, b32_nrm >> 16)
    result = wrap32(b32_inv << 16)
    err_q32 = wrap32(((1 << 29) - smulwb(b32_nrm, b32_inv)) << 3)
    result = wrap32(smlaww(result, err_q32, b32_inv))
    lshift = 61 - b_headrm - qres
    if lshift <= 0:
        return lshift_sat32(result, -lshift)
    if lshift < 32:
        return result >> lshift
    return 0


def div32_varQ(a32: int, b32: int, qres: int) -> int:
    """silk_DIV32_varQ — (a32 << qres) / b32."""
    a_headrm = clz32(silk_abs(a32)) - 1
    a32_nrm = wrap32(a32 << a_headrm)
    b_headrm = clz32(silk_abs(b32)) - 1
    b32_nrm = wrap32(b32 << b_headrm)
    b32_inv = div32_16(I32_MAX >> 2, b32_nrm >> 16)
    result = smulwb(a32_nrm, b32_inv)
    a32_nrm = sub32_ovflw(a32_nrm, lshift_ovflw(smmul(b32_nrm, result), 3))
    result = smlawb(result, a32_nrm, b32_inv)
    lshift = 29 + a_headrm - b_headrm - qres
    if lshift < 0:
        return lshift_sat32(result, -lshift)
    if lshift < 32:
        return result >> lshift
    return 0


def log2lin(in_log_q7: int) -> int:
    """silk_log2lin: 2^(x/128) in Q0."""
    if in_log_q7 < 0:
        return 0
    if in_log_q7 >= 3967:
        return I32_MAX
    out = 1 << (in_log_q7 >> 7)
    frac_q7 = in_log_q7 & 0x7F
    poly = smlawb(frac_q7, smulbb(frac_q7, 128 - frac_q7), -174)
    if in_log_q7 < 2048:
        out = out + ((out * poly) >> 7)
    else:
        out = out + (out >> 7) * poly
    return out



def bwexpander_32(ar: list, d: int, chirp_q16: int) -> None:
    """silk_bwexpander_32 (in-place on Q-anything int32 coefs)."""
    chirp_minus_one_q16 = chirp_q16 - 65536
    for i in range(d - 1):
        ar[i] = smulww(chirp_q16, ar[i])
        chirp_q16 += rshift_round(chirp_q16 * chirp_minus_one_q16, 16)
    ar[d - 1] = smulww(chirp_q16, ar[d - 1])



def smultt(a: int, b: int) -> int:
    return (a >> 16) * (b >> 16)


def add_sat16(a: int, b: int) -> int:
    return sat16(a + b)


def ror32(a: int, rot: int) -> int:
    """Rotate a 32-bit word right by rot (left for negative rot)."""
    u = a & _M32
    if rot == 0:
        return wrap32(u)
    if rot < 0:
        m = (-rot) & 31
        return wrap32(((u << m) | (u >> (32 - m))) & _M32)
    m = rot & 31
    return wrap32(((u >> m) | (u << (32 - m))) & _M32)


def sqrt_approx(x: int) -> int:
    """silk_SQRT_APPROX (fixed-point sqrt, ~10 bits accuracy)."""
    if x <= 0:
        return 0
    lz = clz32(x)
    frac_q7 = ror32(x, 24 - lz) & 0x7F
    y = 32768 if (lz & 1) else 46214
    y >>= lz >> 1
    return smlawb(y, y, smulbb(213, frac_q7))


def bwexpander(ar: list, d: int, chirp_q16: int) -> None:
    """silk_bwexpander (int16 coefs, in place)."""
    chirp_minus_one_q16 = chirp_q16 - 65536
    for i in range(d - 1):
        ar[i] = rshift_round(chirp_q16 * ar[i], 16)
        chirp_q16 += rshift_round(chirp_q16 * chirp_minus_one_q16, 16)
    ar[d - 1] = rshift_round(chirp_q16 * ar[d - 1], 16)


def sum_sqr_shift(x: list) -> tuple:
    """silk_sum_sqr_shift -> (energy, shift): energy of an int16
    vector right-shifted to fit int32 with headroom."""
    length = len(x)
    shft = 31 - clz32(length)
    nrg = length
    i = 0
    while i < length - 1:
        nrg_tmp = x[i] * x[i] + x[i + 1] * x[i + 1]
        nrg = wrap32(nrg + (nrg_tmp >> shft))
        i += 2
    if i < length:
        nrg = wrap32(nrg + ((x[i] * x[i]) >> shft))
    shft = max(0, shft + 3 - clz32(nrg))
    nrg = 0
    i = 0
    while i < length - 1:
        nrg_tmp = x[i] * x[i] + x[i + 1] * x[i + 1]
        nrg = wrap32(nrg + (nrg_tmp >> shft))
        i += 2
    if i < length:
        nrg = wrap32(nrg + ((x[i] * x[i]) >> shft))
    return nrg, shft
