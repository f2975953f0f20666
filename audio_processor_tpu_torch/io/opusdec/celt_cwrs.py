"""PVQ codeword enumeration (RFC 6716 §4.3.4.2, reference cwrs.c):
V(N,K) codeword counts and index -> pulse-vector decoding.  Python
bignums replace the reference's carefully-bounded uint32 arithmetic;
values are identical (libopus guarantees V(N,K) < 2^32 by splitting
bands before K grows too large).
"""

from __future__ import annotations

from typing import List

# Full rectangular DP table, rebuilt (cheap) whenever it must grow.
_U: List[List[int]] = []


def _build(amax: int, bmax: int) -> None:
    global _U
    u = [[0] * (bmax + 1) for _ in range(amax + 1)]
    u[0][0] = 1
    for a in range(1, amax + 1):
        for b in range(1, bmax + 1):
            u[a][b] = u[a - 1][b] + u[a][b - 1] + u[a - 1][b - 1]
    _U = u


def pvq_u(n: int, k: int) -> int:
    """U(N,K) = U(K,N), the number of N-dim vectors of K pulses whose
    first coefficient is positive; U(0,0)=1, U(0,k)=U(n,0)=0 else,
    U(n,k)=U(n-1,k)+U(n,k-1)+U(n-1,k-1) (cwrs.c).  Checked against
    U(2,k)=2k-1 and V(1,k)=2, V(n,0)=1."""
    if n > k:
        n, k = k, n
    if n == 0:
        return 1 if k == 0 else 0
    if k == 0:
        return 0
    if len(_U) <= n or len(_U[0]) <= k:
        _build(max(n, len(_U) - 1, 32),
               max(k, len(_U[0]) - 1 if _U else 0, 256))
    return _U[n][k]


def pvq_v(n: int, k: int) -> int:
    """Number of PVQ codewords for N dims / K pulses."""
    return pvq_u(n, k) + pvq_u(n, k + 1)


def cwrsi(n: int, k: int, i: int) -> List[int]:
    """Index -> signed pulse vector (cwrs.c cwrsi).

    Reads the U table directly (U[a][b] with a <= b; pvq_u's swap and
    zero-edges are already encoded in the table) — the tight search
    loops here account for most pvq_u calls and the call overhead
    dominated the decode profile."""
    hi = max(n, k + 1)
    if len(_U) <= min(n, hi) or len(_U[0]) <= hi:
        pvq_u(n, k + 1)               # grow the table once
    U = _U
    y: List[int] = []
    while n > 2:
        if k >= n:
            p = U[n][k + 1]
            s = -1 if i >= p else 0
            if s:
                i -= p
            k0 = k
            q = U[n][n]
            if q > i:
                k = n
                while True:
                    k -= 1
                    p = U[k][n]
                    if p <= i:
                        break
            else:
                p = U[n][k]
                while p > i:
                    k -= 1
                    p = U[n][k] if n <= k else U[k][n]
            i -= p
            y.append((k0 - k + s) ^ s)
        else:
            p = U[k][n]
            q = U[k + 1][n]
            if p <= i < q:
                i -= p
                y.append(0)
            else:
                s = -1 if i >= q else 0
                if s:
                    i -= q
                k0 = k
                while True:
                    k -= 1
                    p = U[k][n]
                    if p <= i:
                        break
                i -= p
                y.append((k0 - k + s) ^ s)
        n -= 1
    # n == 2
    p = 2 * k + 1
    s = -1 if i >= p else 0
    if s:
        i -= p
    k0 = k
    k = (i + 1) >> 1
    if k:
        i -= 2 * k - 1
    y.append((k0 - k + s) ^ s)
    # n == 1
    s = -i
    y.append((k + s) ^ s)
    return y
