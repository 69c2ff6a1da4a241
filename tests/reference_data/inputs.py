"""The inputs that the port's parity tests and record.py both build.

Seeded bytes, field elements, traces' values and configs, and the AIRs
that the tests define once for each package (a factory takes the
package's module or base class). Imports neither package: numpy, hashlib
and random only. Each ``<module>()`` function returns what the JAX side of
that test module is computed from; ``reference_data.load`` checks its
digest against the recording. An AIR factory counts by its source text.
"""

from __future__ import annotations

import hashlib
import inspect

import numpy as np

P = 0xFFFFFFFF00000001
P25519 = (1 << 255) - 19
L_ORDER = (1 << 252) + 27742317777372353535851937790883648493


def source(*fns) -> list:
    """The source text of `fns`, as inputs: an edited factory is a new input."""
    return [inspect.getsource(fn) for fn in fns]


def encode_compact_u32(v: int) -> bytes:
    """SCALE compact encoding of a u32."""
    if v < 1 << 6:
        return bytes([v << 2])
    if v < 1 << 14:
        return ((v << 2) | 0b01).to_bytes(2, "little")
    if v < 1 << 30:
        return ((v << 2) | 0b10).to_bytes(4, "little")
    n_bytes = (v.bit_length() + 7) // 8
    return bytes([((n_bytes - 4) << 2) | 0b11]) + v.to_bytes(n_bytes, "little")


# -- test_torch_header ----------------------------------------------------------

def make_header(rng, bn: int, size: int) -> bytes:
    parent = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    body = parent + encode_compact_u32(bn)
    body += bytes(rng.integers(0, 256, size - len(body) - 32, dtype=np.uint8))
    return body + bytes(rng.integers(0, 256, 32, dtype=np.uint8))


HEADER = make_header(np.random.default_rng(3), 1000, 100)
HEADER_CFG = dict(rate_bits=2, num_queries=6, final_poly_len=4)


def test_torch_header():
    return {"header": HEADER, "cfg": HEADER_CFG}


# -- test_torch_stark -----------------------------------------------------------

STARK_LOG_N = 5
# the __graft_entry__.entry config, and the same with grinding
STARK_CONFIGS = {
    "entry": dict(rate_bits=2, num_queries=6, final_poly_len=4),
    "pow8": dict(rate_bits=2, num_queries=6, final_poly_len=4, pow_bits=8),
}


def test_torch_stark():
    return {"log_n": STARK_LOG_N, "configs": STARK_CONFIGS}


# -- test_torch_lookup: the range, RAM and constant-column AIRs -------------------

# one trace length for every case, so that the JAX side compiles its
# transforms once
LOOKUP_LOG_N = 5
LOOKUP_N = 1 << LOOKUP_LOG_N
LOOKUP_CFG = dict(rate_bits=2, num_queries=6, final_poly_len=4)
GAMMA = (0x0123456789ABCDEF % P, P - 5)
DELTA = (P - (1 << 32) + 7, 0xFEDCBA9876543210 % P)


def range_air(base):
    class RangeAir(base):
        """Two committed columns, both range-checked to [0, N) via LogUp."""
        num_cols = 2
        num_publics = 1
        max_constraint_degree = 3

        def lookup_range_columns(self):
            return [0, 1]

        def first_row(self, alg, local, publics, consts=()):
            return [alg.sub(local[0], alg.lift(publics[0]))]
    return RangeAir()


def odd_range_air(base):
    class OddRangeAir(base):
        """Three looked columns: the odd count repeats the last."""
        num_cols = 3
        num_publics = 1

        def lookup_range_columns(self):
            return [0, 1, 2]

        def first_row(self, alg, local, publics, consts=()):
            return [alg.sub(local[0], alg.lift(publics[0]))]
    return OddRangeAir()


def ram_air(base, unmatched=False):
    class RamAir(base):
        """One committed value column; mult/load/addr/active in consts.
        Rows 0-7 store addrs 100..107; rows 12-19 load them reversed; row
        24 re-loads addr 100; row 25 is a zero-multiplicity store."""
        num_cols = 1
        num_publics = 1
        n_rows = LOOKUP_N

        def ram_multiset(self):
            return (0, 1, 2, 3, 0)

        def constant_columns(self, n_rows):
            out = np.zeros((4, n_rows), dtype=np.uint64)
            for i in range(8):
                out[0, i] = 2 if i == 0 else 1
                out[2, i] = 100 + i
                out[3, i] = 1
            for i in range(8):
                out[1, 12 + i] = 1
                out[2, 12 + i] = 107 - i
                out[3, 12 + i] = 1
            out[1, 24], out[2, 24], out[3, 24] = 1, 100, 1
            out[2, 25], out[3, 25] = 200, 1
            if unmatched:                  # a load from a never-stored address
                out[1, 26], out[2, 26], out[3, 26] = 1, 55, 1
            return out
    return RamAir()


def const_air(base, seed=0):
    class ConstAffineAir(base):
        """One column x with x' = x + c(i); c is a public constant column."""
        num_cols = 1
        num_publics = 2

        def constant_columns(self, n_rows):
            out = np.zeros((1, n_rows), dtype=np.uint64)
            for i in range(n_rows):
                out[0, i] = (7 * i * i + 3 * i + 1 + seed) % P
            return out

        def transition(self, alg, local, next_row, publics, consts=(),
                       consts_next=()):
            return [alg.sub(next_row[0], alg.add(local[0], consts[0]))]

        def first_row(self, alg, local, publics, consts=()):
            return [alg.sub(local[0], alg.lift(publics[0]))]

        def last_row(self, alg, local, publics, consts=()):
            return [alg.sub(local[0], alg.lift(publics[1]))]
    return ConstAffineAir()


def range_case(n, cols=2, bad=False):
    rng = np.random.default_rng(11)
    vals = rng.integers(0, n, (cols, n), dtype=np.uint64)
    if bad:
        vals[1, 17] = n + 3                 # out of range
    return vals.astype(object), [int(vals[0, 0])]


def ram_vals(wrong_load=False, unmatched=False):
    vals = np.zeros(LOOKUP_N, dtype=object)
    stored = {100 + i: 1000 + 7 * i for i in range(8)}
    for i in range(8):
        vals[i] = stored[100 + i]
        vals[12 + i] = stored[107 - i]
    vals[24] = stored[100]
    vals[25] = 424242
    if wrong_load:
        vals[12] = 999999
    if unmatched:
        vals[26] = 1234
    return vals[None, :], [7]


def const_case(seed=0, n=LOOKUP_N):
    c = const_air(object, seed).constant_columns(n)[0]
    xs = [5]
    for i in range(n - 1):
        xs.append((xs[-1] + int(c[i])) % P)
    return np.array([xs], dtype=object), [5, xs[-1]]


# name -> (air factory, (trace values, publics), log_n)
LOOKUP_CASES = {
    "range": (range_air, range_case(LOOKUP_N), LOOKUP_LOG_N),
    "ram": (ram_air, ram_vals(), LOOKUP_LOG_N),
    "const_vk": (const_air, const_case(), LOOKUP_LOG_N),
}
# aux trace only (no proof): three looked columns
ODD_RANGE = (odd_range_air, range_case(LOOKUP_N, cols=3), LOOKUP_LOG_N)
BAD_RANGE = (range_air, range_case(LOOKUP_N, bad=True), LOOKUP_LOG_N)


def test_torch_lookup():
    return {"cases": {k: v[1:] for k, v in LOOKUP_CASES.items()},
            "odd_range": ODD_RANGE[1:], "bad_range": BAD_RANGE[1:],
            "cfg": LOOKUP_CFG, "gamma": GAMMA, "delta": DELTA,
            "airs": source(range_air, odd_range_air, ram_air, const_air,
                           const_case)}


# -- test_torch_recursion ---------------------------------------------------------

REC_LOG_N = 4
REC_CFG = dict(rate_bits=1, num_queries=2, final_poly_len=4)


def range_rec_case():
    """tests/test_recursion_air.py's lookup case: both columns in [0, N)."""
    rng = np.random.default_rng(7)
    n = 1 << REC_LOG_N
    vals = rng.integers(0, n, (2, n), dtype=np.uint64)
    return vals.astype(object), [int(vals[0, 0])]


# name -> how the inner trace is made (the trace builders are each
# package's own), and log_n
REC_INNER = {
    "fib": ({"fibonacci": 1 << REC_LOG_N}, REC_LOG_N),
    "range": ({"values": range_rec_case()}, REC_LOG_N),
    "const": ({"values": const_case(n=1 << REC_LOG_N)}, REC_LOG_N),
    "poseidon": ({"poseidon_chain": (list(range(1, 13)), 2)}, 6),
}
REC_TWO_LEVEL_CFG1 = dict(rate_bits=1, num_queries=2, final_poly_len=32)
REC_RECURSIVE_N = 8
REC_TRANSITION_SEED = 23


def test_torch_recursion():
    return {"inner": REC_INNER, "cfg": REC_CFG, "cfg1": REC_TWO_LEVEL_CFG1,
            "recursive_n": REC_RECURSIVE_N,
            "transition_seed": REC_TRANSITION_SEED,
            "airs": source(range_air, const_air, const_case)}


# -- test_torch_aggregate -----------------------------------------------------------

AGG_N = 16
AGG_LINKS = [(0, 2, 1, 0)]
AGG_EXPOSE = [(0, 0), (1, 2)]


def test_torch_aggregate():
    return {"n": AGG_N, "cfg": REC_CFG, "links": AGG_LINKS,
            "expose": AGG_EXPOSE}


# -- the recursion machine's trace on sampled rows ----------------------------------

SAMPLE = 4096


def sample_rows(n: int, seed: int = 5) -> np.ndarray:
    """SAMPLE seeded rows of n, the first two and the last two included."""
    rng = np.random.default_rng(seed)
    return np.unique(np.concatenate([[0, 1, n - 2, n - 1],
                                     rng.integers(0, n, SAMPLE - 4)]))


# -- test_torch_dsl -------------------------------------------------------------------

DSL_CFG = dict(rate_bits=1, num_queries=2, final_poly_len=4)
DSL_LOG_N = 5
DSL_POSEIDON = (list(range(12)), 1)      # PoseidonChainAir.make_trace input


def acc_air(mod):
    """tests/test_dsl.py's accumulator: v' = flag ? v + 1 : v over a u32
    family and a bit, authored in `mod` (the port's DSL or the JAX
    package's) -> (builder, air, v, flag)."""
    b = mod.AirBuilder(num_publics=2, name="acc")
    v = b.u32("v")
    flag = b.bit("flag")

    @b.transition
    def _(ctx):
        ctx.eq(ctx.nxt(v.value),
               ctx.select(ctx.cur(flag), ctx.cur(v.value) + 1,
                          ctx.cur(v.value)))

    @b.first_row
    def _(ctx):
        ctx.eq(ctx.cur(v.value), ctx.pub(0))

    @b.last_row
    def _(ctx):
        ctx.eq(ctx.cur(v.value), ctx.pub(1))

    return b, b.build(), v, flag


def combinators_air(mod):
    """Every DSL construct the two AIRs above leave out, on a few columns:
    dot with wide and negative coefficients, one_hot_dot, recompose,
    rlc_window, sum, neg/rsub, one and zero_e, a constant column read at
    the current and the next row, a range-checked column and a u16 in a
    select, a public in every class, an every_row constraint."""
    b = mod.AirBuilder(num_publics=3, name="combinators")
    x = b.felts("x", 4)
    r = b.range_checked("r")
    h = b.u16("h")
    k = b.constant("k", [3, 1, 4, 1, 5, 9, 2, 6])

    @b.transition
    def _(ctx):
        c = [ctx.cur(v) for v in x]
        ctx.eq(ctx.nxt(x[0]), ctx.dot(c, [5, P - 1, 7, 1 << 40]))
        ctx.zero(ctx.one_hot_dot(c[:3], [11, 22, 33])
                 - ctx.recompose(c, 1 << 16))
        ctx.eq(ctx.rlc_window(ctx.pub(2), c),
               ctx.sum(c) * ctx.cur(k) + ctx.nxt(k))
        ctx.zero(-(c[1] - 3) + (5 - c[2]) * ctx.one() + ctx.zero_e())
        ctx.eq(ctx.select(c[3], ctx.cur(r), ctx.cur(h.value)), ctx.pub(0))

    @b.first_row
    def _(ctx):
        ctx.eq(ctx.cur(x[0]), ctx.pub(1))
        ctx.zero(ctx.cur(k) - 3)

    @b.every_row
    def _(ctx):
        ctx.eq(ctx.cur(r) * ctx.cur(r), ctx.cur(x[1]))

    return b.build()


DSL_AIRS = {"acc": lambda mod: acc_air(mod)[1], "combinators": combinators_air}


def dsl_constraint_inputs(num_cols, k, num_publics, ring):
    """The seeded rows, constants and publics of the constraint-value
    test: vals [local, next, consts, consts_next] x [re, im] x columns x
    points, and the publics."""
    rng = np.random.default_rng(41)
    m = 8 if ring == "base" else 1
    vals = rng.integers(0, P, (4, 2, max(num_cols, k), m), dtype=np.uint64)
    pubs = [int(x) for x in rng.integers(0, P, num_publics, dtype=np.uint64)]
    return vals, pubs


def test_torch_dsl():
    return {"cfg": DSL_CFG, "log_n": DSL_LOG_N, "poseidon": DSL_POSEIDON,
            "airs": source(acc_air, combinators_air, dsl_constraint_inputs,
                           sample_rows)}


# -- test_torch_recursion_leaf ----------------------------------------------------------

LEAF_HEADER = make_header(np.random.default_rng(21), 123456, 120)
LEAF_CFG = dict(rate_bits=1, num_queries=2, final_poly_len=4)
LEAF_LOG_N = 7


def test_torch_recursion_leaf():
    return {"header": LEAF_HEADER, "cfg": LEAF_CFG, "log_n": LEAF_LOG_N,
            "rows": source(sample_rows)}


# -- test_torch_statement_airs (and its _sha256_merkle, _sha512 files) --------------

STMT_CFG = dict(rate_bits=1, num_queries=2, final_poly_len=4)
STMT_MSG = b"vectorx precommit message of fifty-three bytes..!#%&("
_STMT_RNG = np.random.default_rng(77)
STMT_STATE = [int(x) % P for x in _STMT_RNG.integers(0, 1 << 64, 12,
                                                      dtype=np.uint64)]
STMT_KEYS = [_STMT_RNG.bytes(32) for _ in range(2)]
STMT_LEAVES = [_STMT_RNG.bytes(32) for _ in range(4)]
# test module -> the AIRs whose payload parity it holds
STMT_MODULES = {
    "test_torch_statement_airs": ("poseidon_chain", "sha256_chain"),
    "test_torch_statement_sha256_merkle": ("sha256_merkle",),
    "test_torch_statement_sha512": ("sha512",),
}


def sha512_lane(seed):
    rng = np.random.default_rng(seed)
    a, r = rng.bytes(32), rng.bytes(32)
    s = int.from_bytes(rng.bytes(31), "little")
    h = int.from_bytes(hashlib.sha512(r + a + STMT_MSG).digest(),
                       "little") % L_ORDER
    return (a, r, s, h)


def leaf_words(raw):
    return [[int.from_bytes(b[4 * i:4 * i + 4], "big") for i in range(8)]
            for b in raw]


def statement(module):
    return {"cfg": STMT_CFG, "msg": STMT_MSG, "state": STMT_STATE,
            "keys": STMT_KEYS, "leaves": leaf_words(STMT_LEAVES),
            "lane": sha512_lane(7), "airs": STMT_MODULES[module]}


def test_torch_statement_airs():
    return statement("test_torch_statement_airs")


def test_torch_statement_sha256_merkle():
    return statement("test_torch_statement_sha256_merkle")


def test_torch_statement_sha512():
    return statement("test_torch_statement_sha512")


# -- test_torch_gadget_fp25519 ----------------------------------------------------------

FP_LOG_N = 8
FP_CFG = dict(rate_bits=2, num_queries=6, final_poly_len=4)


def fp25519_inputs(seed: int = 31):
    """256 seeded pairs (a, b) of field elements, a first (chip_smoke.py's
    ``fp25519_inputs``)."""
    rng = np.random.default_rng(seed)
    draw = [int.from_bytes(rng.bytes(32), "little") % P25519
            for _ in range(2 << FP_LOG_N)]
    return draw[:1 << FP_LOG_N], draw[1 << FP_LOG_N:]


def test_torch_gadget_fp25519(ab):
    """`ab`: the (a, b) values the AIR's witness is built from."""
    return {"ab": ab, "cfg": FP_CFG}


# -- Ed25519 keys and signatures (RFC 8032 on Python ints) --------------------------

ED_D = -121665 * pow(121666, P25519 - 2, P25519) % P25519
ED_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
ED_BY = 46316835694926478169428394003475163141307993866256225615783033603165251855960


def _ed_add(p1, p2):
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % P25519
    b = (y1 + x1) * (y2 + x2) % P25519
    c = 2 * ED_D * t1 * t2 % P25519
    d = 2 * z1 * z2 % P25519
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % P25519, g * h % P25519, f * g % P25519, e * h % P25519


def _ed_base_mul(k: int) -> bytes:
    """The encoding of [k]B."""
    acc, pt = (0, 1, 1, 0), (ED_BX, ED_BY, 1, ED_BX * ED_BY % P25519)
    while k:
        if k & 1:
            acc = _ed_add(acc, pt)
        pt = _ed_add(pt, pt)
        k >>= 1
    x, y, z, _ = acc
    zi = pow(z, P25519 - 2, P25519)
    return compress(x * zi % P25519, y * zi % P25519)


def compress(x: int, y: int) -> bytes:
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _ed_secret(seed: bytes):
    digest = hashlib.sha512(seed).digest()
    a = int.from_bytes(digest[:32], "little")
    return (a & ((1 << 254) - 8)) | (1 << 254), digest[32:]


def ed25519_public_key(seed: bytes) -> bytes:
    return _ed_base_mul(_ed_secret(seed)[0])


def ed25519_sign(seed: bytes, msg: bytes) -> bytes:
    """The 64-byte signature R | S of `msg` by the key of `seed`."""
    a, prefix = _ed_secret(seed)
    pub = _ed_base_mul(a)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L_ORDER
    r_enc = _ed_base_mul(r)
    k = int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(),
                       "little") % L_ORDER
    return r_enc + ((r + k * a) % L_ORDER).to_bytes(32, "little")


def dummy_sig():
    """The disabled lane's (A, R, s, h): the base point, the identity."""
    return (compress(ED_BX, ED_BY), compress(0, 1), 0, 0)


def sig_lanes(pubkeys, signatures, signed, message):
    """(A, R, s, h) of each signed lane, h = SHA-512(R | A | M) mod L;
    the dummy for the others."""
    out = []
    for pk, sg, en in zip(pubkeys, signatures, signed):
        if not en:
            out.append(dummy_sig())
            continue
        h = int.from_bytes(hashlib.sha512(bytes(sg[:32]) + bytes(pk)
                                          + message).digest(),
                           "little") % L_ORDER
        out.append((bytes(pk), bytes(sg[:32]),
                    int.from_bytes(bytes(sg[32:]), "little"), h))
    return out


def encode_precommit_bytes(block_hash: bytes, block_number: int, round_: int,
                           authority_set_id: int) -> bytes:
    """The signed GRANDPA precommit: 1 | hash | number (u32 LE) | round
    (u64 LE) | set id (u64 LE)."""
    return (bytes([1]) + block_hash + block_number.to_bytes(4, "little")
            + round_.to_bytes(8, "little")
            + authority_set_id.to_bytes(8, "little"))


def authority_set_hash(pubkeys) -> bytes:
    """Chained SHA-256 over 32-byte Ed25519 public keys."""
    h = b""
    for pk in pubkeys:
        h = hashlib.sha256(h + pk).digest()
    return h


# -- test_torch_ed25519_air and _ext: Ed25519VerifyAir(B = 8) ---------------------

ED_B = 8
ED_MSG = np.random.default_rng(53).bytes(53)


def signed_lane(seed: int, msg: bytes = ED_MSG):
    """(A, R, s, h) of a signature by the key made from seeded bytes."""
    key = np.random.default_rng(seed).bytes(32)
    return sig_lanes([ed25519_public_key(key)], [ed25519_sign(key, msg)],
                     [True], msg)[0]


ED_LANES = {"signed": signed_lane(7), "dummy": dummy_sig()}


def test_torch_ed25519_air(lanes=ED_LANES):
    """`lanes`: the AIR's lanes, by name (the test signs its own)."""
    return {"lanes": lanes, "B": ED_B, "seed": 8}


def test_torch_ed25519_ext(lanes=ED_LANES):
    return {"lanes": lanes, "B": ED_B, "seed": 9}


# -- test_torch_gadget_vec: VecGadgetAir --------------------------------------------

GV_B = 8
GV_L = 32
GV_N = 1 << GV_B
GV_K0 = 0x1234567890ABCDEF1234567890ABCDEF


def random_columns(rng, k: int, n: int) -> np.ndarray:
    """(k, n) canonical Goldilocks values as uint64."""
    return rng.integers(0, P, (k, n), dtype=np.uint64)


def vec_gadget_air(mod, base):
    class VecGadgetAir(base):
        """Per row: c0 = a·b; c1 = c0·a; c2 = (c0 + 4p − c1)·b; d0 = c0·K0;
        na = −a, nb = −b (LinZero); canonicity of a and b."""
        num_publics = 1
        max_constraint_degree = 3

        def __init__(self):
            alloc = mod.AllocV()
            self.a = alloc.take_np((GV_L,))
            self.b = alloc.take_np((GV_L,))
            self.na = alloc.take_np((GV_L,))
            self.nb = alloc.take_np((GV_L,))
            self.vm = mod.MulBank(alloc, GV_B, 3, a_limb_max=1 << (GV_B + 3),
                                  b_limb_max=(1 << GV_B) - 1)
            self.cm = mod.MulBank(alloc, GV_B, 1, a_limb_max=(1 << GV_B) - 1,
                                  b_limb_max=(1 << GV_B) - 1)
            self.lz = mod.LinZeroBank(alloc, GV_B, 2, s_limb_max=1 << (GV_B + 1))
            self.cb = mod.CanonBank(alloc, GV_B, 2)
            self.num_cols = alloc.n
            self._lookups = alloc.lookups

        def lookup_range_columns(self):
            return self._lookups

        def transition(self, alg, local, next_row, publics, consts=(),
                       consts_next=()):
            lim = (1 << GV_B) - 1
            a = mod.t_gather(local, self.a)
            b = mod.t_gather(local, self.b)
            na = mod.t_gather(local, self.na)
            nb = mod.t_gather(local, self.nb)
            c0 = self.vm.c_inst(local, 0)
            c1 = self.vm.c_inst(local, 1)
            a_lins = [mod.lin([(1, a)], limb_max=lim),
                      mod.lin([(1, c0)], limb_max=lim),
                      mod.lin([(1, c0), (-1, c1)], const=4 * P25519,
                              limb_max=6 * (1 << GV_B))]
            b_lins = [mod.lin([(1, b)], limb_max=lim),
                      mod.lin([(1, a)], limb_max=lim),
                      mod.lin([(1, b)], limb_max=lim)]
            cs = list(self.vm.constraints(alg, local, a_lins, b_lins=b_lins))
            cs += self.cm.constraints(alg, local,
                                      [mod.lin([(1, c0)], limb_max=lim)],
                                      b_consts=[GV_K0])
            cs += self.lz.constraints(
                alg, local, [mod.lin([(1, a), (1, na)], limb_max=2 * lim),
                             mod.lin([(1, b), (1, nb)], limb_max=2 * lim)])
            cs += self.cb.constraints(alg, local, [a, b])
            return cs
    return VecGadgetAir()


def _rand_fe(rng, k):
    return [int.from_bytes(rng.bytes(32), "little") % (P25519 - 1) + 1
            for _ in range(k)]


_GV_RNG = np.random.default_rng(77)
GV_A_VALS, GV_B_VALS = _rand_fe(_GV_RNG, GV_N), _rand_fe(_GV_RNG, GV_N)


def test_torch_gadget_vec():
    return {"air": source(vec_gadget_air), "seeds": (5, 6)}


# -- test_torch_statements_rotate: RotateHeaderAir ------------------------------------

ROT_MAX_CHUNKS = 2
ROT_EPOCH_END_BLOCK = 180


def epoch_end_header(rng, block_number, new_pubkeys):
    """A SCALE header with a GRANDPA ScheduledChange consensus log."""
    parent, state_root, extrinsics_root, data_root = (rng.bytes(32)
                                                      for _ in range(4))
    recs = b"".join(pk + b"\x01" + bytes(7) for pk in new_pubkeys)
    message = (b"\x01" + encode_compact_u32(len(new_pubkeys)) + recs
               + bytes(4))
    log = b"\x04" + b"FRNK" + encode_compact_u32(len(message)) + message
    return (parent + encode_compact_u32(block_number) + state_root
            + extrinsics_root + b"\x04" + log + data_root)


def rotate_header() -> bytes:
    """The test's header: from default_rng(41) after the bytes of one
    current key and two new keys (whose public keys it schedules)."""
    rng = np.random.default_rng(41)
    rng.bytes(32)
    new_pubs = [ed25519_public_key(rng.bytes(32)) for _ in range(2)]
    return epoch_end_header(rng, ROT_EPOCH_END_BLOCK, new_pubs)


def test_torch_statements_rotate(header=None):
    """`header`: the RotateHeaderAir's header (the test builds its own)."""
    return {"header": rotate_header() if header is None else header,
            "max_chunks": ROT_MAX_CHUNKS, "seed": 12}


def seeded_keys(rng, n: int):
    """n key seeds drawn from `rng`, and their public keys."""
    seeds = [rng.bytes(32) for _ in range(n)]
    return seeds, [ed25519_public_key(s) for s in seeds]


# -- test_torch_ed25519_batch: the batched point arithmetic -------------------------

EB_MSG = encode_precommit_bytes(bytes(range(32)), 1234, 5, 6)
EB_LANES = ("signed0", "disabled", "flipped_s", "bad_r", "wrong_key",
            "signed1", "signed2", "disabled_garbage")


def non_square_y() -> int:
    """The smallest y whose x^2 = (y^2 - 1) / (d y^2 + 1) has no root."""
    p = P25519
    for y in range(2, 100):
        u, v = (y * y - 1) % p, (ED_D * y * y + 1) % p
        if pow(u * pow(v, p - 2, p) % p, (p - 1) // 2, p) == p - 1:
            return y
    raise AssertionError("no non-square below 100")


def ed_encodings():
    """-> (names, (n, 32) uint8) of the decompression cases."""
    _, pubs = seeded_keys(np.random.default_rng(61), 2)
    cases = {f"valid{i}": p for i, p in enumerate(pubs)}
    cases["y_eq_p"] = P25519.to_bytes(32, "little")
    cases["y_ge_p"] = (P25519 + 3).to_bytes(32, "little")
    cases["non_square"] = non_square_y().to_bytes(32, "little")
    cases["x0_sign"] = (1 | (1 << 255)).to_bytes(32, "little")
    cases["x0"] = (1).to_bytes(32, "little")
    cases["dummy"] = bytes(32)
    names = list(cases)
    return names, np.stack([np.frombuffer(cases[k], np.uint8) for k in names])


def ed_lanes():
    """-> (pk, sig, enabled) of the verification lanes EB_LANES."""
    seeds, pubs = seeded_keys(np.random.default_rng(62), 8)
    sigs = [ed25519_sign(s, EB_MSG) for s in seeds]
    enabled = np.ones(8, bool)
    enabled[1] = enabled[7] = False
    sigs[2] = sigs[2][:32] + bytes([sigs[2][32] ^ 1]) + sigs[2][33:]
    sigs[3] = bytes([sigs[3][0] ^ 4]) + sigs[3][1:]
    pubs[4] = pubs[5]
    sigs[7] = bytes(range(64))
    pk = np.stack([np.frombuffer(p, np.uint8) for p in pubs])
    sg = np.stack([np.frombuffer(s, np.uint8) for s in sigs])
    return pk, sg, enabled


def scalar_bytes():
    rng = np.random.default_rng(63)
    s = rng.integers(0, 256, (8, 32), dtype=np.uint8)
    s[0] = 0
    s[1] = 255
    return s


def test_torch_ed25519_batch():
    return {"encodings": ed_encodings(), "lanes": ed_lanes(),
            "scalars": scalar_bytes(), "msg": EB_MSG}


# -- test_torch_header_range: the witness-level programs ----------------------------

HR_MAX_N = 8
HR_TREE = 8
HR_S = 512
U32 = 1 << 32


def pack_headers(headers, tree_size: int, max_header_size: int):
    """SCALE header bytes -> padded (tree_size, S) uint8 buffer + sizes."""
    buf = np.zeros((tree_size, max_header_size), dtype=np.uint8)
    sizes = np.zeros((tree_size,), dtype=np.int32)
    for i, h in enumerate(headers):
        buf[i, :len(h)] = np.frombuffer(h, dtype=np.uint8)
        sizes[i] = len(h)
    return buf, sizes


def _chain(rng, trusted_hash, trusted_block, n, size=300, numbers=None):
    """Chained SCALE-shaped headers -> (headers, hash of the last)."""
    headers, parent = [], trusted_hash
    for i in range(n):
        bn = numbers[i] if numbers else (trusted_block + 1 + i) % U32
        body = parent + encode_compact_u32(bn) + rng.bytes(32)
        hdr = body + rng.bytes(size - len(body) - 32) + rng.bytes(32)
        headers.append(hdr)
        parent = hashlib.blake2b(hdr, digest_size=32).digest()
    return headers, parent


def _justification_record(seeds, pubs, block_hash, block_number, set_id,
                          n_sign):
    """The indexer's record fields of a justification."""
    msg = encode_precommit_bytes(block_hash, block_number, 1, set_id)
    sigs = [ed25519_sign(s, msg).hex() if i < n_sign else bytes(64).hex()
            for i, s in enumerate(seeds)]
    return ([p.hex() for p in pubs], sigs,
            [i < n_sign for i in range(len(seeds))], len(seeds), msg)


def header_range_case(seed, trusted_block=1000, n=5, n_auth=4, n_sign=None,
                      wrong_set=False, break_link=False, bad_number=False):
    rng = np.random.default_rng(seed)
    trusted_hash = rng.bytes(32)
    numbers = [(trusted_block + 1 + i) % U32 for i in range(n)]
    if bad_number:
        numbers[2] += 1
    headers, target_hash = _chain(rng, trusted_hash, trusted_block, n,
                                  numbers=numbers)
    if break_link:
        h = bytearray(headers[3])
        h[5] ^= 1
        headers[3] = bytes(h)
    seeds, pubs = seeded_keys(rng, n_auth)
    target = (trusted_block + n) % U32
    rec = _justification_record(seeds, pubs, target_hash, target, 9,
                                n_auth if n_sign is None else n_sign)
    set_hash = bytes(32) if wrong_set else authority_set_hash(pubs)
    buf, sizes = pack_headers(headers, HR_TREE, HR_S)
    return dict(trusted=trusted_block, trusted_hash=trusted_hash,
                set_id=9, set_hash=set_hash, target=target, buf=buf,
                sizes=sizes, rec=rec, n=n)


def _epoch_end_with_tail(rng, new_pubs, tail=b""):
    """A header whose digest holds a ScheduledChange for new_pubs, with
    `tail` after the log -> (header, start_position)."""
    validators = b"".join(p + b"\x01" + bytes(7) for p in new_pubs)
    sched = (b"\x01" + encode_compact_u32(len(new_pubs)) + validators
             + bytes(4))
    log = b"\x04" + b"FRNK" + encode_compact_u32(len(sched)) + sched
    body = rng.bytes(32) + encode_compact_u32(123) + rng.bytes(32)
    filler = rng.bytes(40)
    return body + filler + b"\x00" + log + tail, len(body) + len(filler)


def rotate_case(seed, n_new, padded_to=None):
    """padded_to: the buffer's size (None: the header zero-padded to whole
    128-byte chunks, as the CLI pads it)."""
    rng = np.random.default_rng(seed)
    seeds, pubs = seeded_keys(rng, 4)
    _, new_pubs = seeded_keys(rng, n_new)
    tail = rng.bytes(HR_S - 64 - 150 - 40 * n_new) if padded_to else b""
    hdr, start = _epoch_end_with_tail(rng, new_pubs, tail)
    size = padded_to or len(hdr) + (-len(hdr)) % 128
    hb = np.zeros((size,), np.uint8)
    hb[:len(hdr)] = np.frombuffer(hdr, np.uint8)
    pk = np.zeros((HR_MAX_N, 32), np.uint8)
    for i, p in enumerate(new_pubs):
        pk[i] = np.frombuffer(p, np.uint8)
    target_hash = hashlib.blake2b(hdr, digest_size=32).digest()
    rec = _justification_record(seeds, pubs, target_hash, 4321, 10, 4)
    return dict(set_id=10, set_hash=authority_set_hash(pubs),
                block=4321, hb=hb, size=len(hdr), n_new=n_new, start=start,
                pk=pk, rec=rec, new_hash=authority_set_hash(new_pubs))


HR_CASES = {
    "honest": dict(seed=1),
    "minority": dict(seed=2, n_auth=6, n_sign=4),
    "wrong_set_hash": dict(seed=3, wrong_set=True),
    "broken_link": dict(seed=4, break_link=True),
    "wrong_block_number": dict(seed=5, bad_number=True),
    "u32_wrap": dict(seed=6, trusted_block=U32 - 3),
}
ROT_CASES = {
    "honest": dict(seed=7, n_new=5, padded_to=HR_S),
    "window_past_end": dict(seed=8, n_new=2),
}


def short_epoch_case(c):
    """The same header cut where its delay bytes start: the delay window
    lies past the buffer."""
    delay_at = c["size"] - 4
    return dict(c, hb=c["hb"][:delay_at])


def header_range_cases():
    return ({k: header_range_case(**v) for k, v in HR_CASES.items()},
            {k: rotate_case(**v) for k, v in ROT_CASES.items()})


def test_torch_header_range(cases=None):
    """`cases`: header_range_cases() (built once by the caller)."""
    return {"cases": header_range_cases() if cases is None else cases,
            "max_n": HR_MAX_N}
