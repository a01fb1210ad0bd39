"""Legacy Keccak-256 (pre-NIST padding 0x01), pure python.

Needed because gnark-crypto derives MiMC round constants with
sha3.NewLegacyKeccak256 (original Keccak submission padding), which
differs from hashlib's sha3_256 (NIST SHA-3, padding 0x06).
"""

_ROT = [[0, 36, 3, 41, 18],
        [1, 44, 10, 45, 2],
        [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56],
        [27, 20, 39, 8, 14]]

_RC = [0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
       0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
       0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
       0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
       0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
       0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
       0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
       0x8000000000008080, 0x0000000080000001, 0x8000000080008008]

_M = (1 << 64) - 1


def _rol(x, s):
    return ((x << s) | (x >> (64 - s))) & _M


def _keccak_f(A):
    for rc in _RC:
        # theta
        C = [A[x][0] ^ A[x][1] ^ A[x][2] ^ A[x][3] ^ A[x][4]
             for x in range(5)]
        D = [C[(x - 1) % 5] ^ _rol(C[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                A[x][y] ^= D[x]
        # rho + pi
        B = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                B[y][(2 * x + 3 * y) % 5] = _rol(A[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                A[x][y] = B[x][y] ^ ((~B[(x + 1) % 5][y] & _M)
                                     & B[(x + 2) % 5][y])
        # iota
        A[0][0] ^= rc
    return A


def keccak256(data: bytes) -> bytes:
    """Legacy Keccak-256 digest (rate 1088 bits, pad 0x01 .. 0x80)."""
    rate = 136
    # multi-rate padding with 0x01 domain byte (legacy)
    padlen = rate - (len(data) % rate)
    padded = data + bytes([0x01] + [0] * (padlen - 2) + [0x80]) \
        if padlen >= 2 else data + bytes([0x81])
    A = [[0] * 5 for _ in range(5)]
    for off in range(0, len(padded), rate):
        block = padded[off:off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i:8 * i + 8], "little")
            A[i % 5][i // 5] ^= lane
        _keccak_f(A)
    out = b""
    for i in range(4):
        out += A[i % 5][i // 5].to_bytes(8, "little")
    return out
