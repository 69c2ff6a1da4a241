"""PoseidonChainAir re-authored in the DSL (stark/dsl.py): a production
AIR expressed through the typed builder without touching the proof
system.

Column layout is IDENTICAL to air_poseidon.PoseidonChainAir (s | x3 |
x7 | ph) and so is the constraint order, so the hand-written AIR's
`make_trace` output satisfies this one verbatim
(tests/test_torch_dsl.py)."""

from __future__ import annotations

from ..hashes import poseidon as ps
from .air_poseidon import PERIOD, WIDTH, _FULL, _PARTIAL
from .dsl import AirBuilder


def build_poseidon_chain_air():
    """-> (air, handles) with handles = (s, x3, x7, ph)."""
    b = AirBuilder(num_publics=2 * WIDTH, name="poseidon_chain_dsl")
    s = b.felts("s", WIDTH)
    x3 = b.felts("x3", WIDTH)
    x7 = b.felts("x7", WIDTH)
    # felts + explicit booleanity (not b.bits) keep the constraint ORDER
    # of the hand-written AIR: bits() would emit booleanity ahead of the
    # rotation constraints.
    ph = b.felts("ph", PERIOD)

    rc = ps.round_constants()
    mds = ps.mds_matrix()

    @b.transition
    def _(ctx):
        cur = [ctx.cur(c) for c in s]
        phc = [ctx.cur(c) for c in ph]

        # phase register: boolean, rotating, sums to one
        for r in range(PERIOD):
            ctx.zero(phc[r] * phc[r] - phc[r])
        for r in range(PERIOD):
            ctx.eq(ctx.nxt(ph[r]), phc[(r - 1) % PERIOD])
        ctx.eq(ctx.sum(phc), 1)

        # per-lane round constant: one-hot blend through the phase
        def rc_lane(i):
            return ctx.one_hot_dot(phc[:ps.N_ROUNDS],
                                   [rc[r][i] for r in range(ps.N_ROUNDS)])

        flag_full = ctx.sum([phc[r] for r in sorted(_FULL)])
        flag_partial = ctx.sum([phc[r] for r in sorted(_PARTIAL)])
        flag_copy = phc[30] + phc[31]

        t = [cur[i] + rc_lane(i) for i in range(WIDTH)]

        # S-box splitters: x3 = t^3, x7 = x3^2 · t
        for i in range(WIDTH):
            ctx.eq(ctx.cur(x3[i]), t[i] * t[i] * t[i])
            x3i = ctx.cur(x3[i])
            ctx.eq(ctx.cur(x7[i]), x3i * x3i * t[i])

        # blended S-box output (x^7 on all lanes in full rounds, lane 0
        # only in partial rounds)
        sb = []
        for i in range(WIDTH):
            part = ctx.cur(x7[0]) if i == 0 else t[i]
            sb.append(flag_full * ctx.cur(x7[i]) + flag_partial * part)

        # state transition: next = copy ? s : MDS(sb)
        not_copy = 1 - flag_copy
        for i in range(WIDTH):
            mds_out = ctx.dot(sb, [mds[i][j] for j in range(WIDTH)])
            ctx.eq(ctx.nxt(s[i]),
                   flag_copy * cur[i] + not_copy * mds_out)

    @b.first_row
    def _(ctx):
        for i in range(WIDTH):
            ctx.eq(ctx.cur(s[i]), ctx.pub(i))
        ctx.eq(ctx.cur(ph[0]), 1)

    @b.last_row
    def _(ctx):
        for i in range(WIDTH):
            ctx.eq(ctx.cur(s[i]), ctx.pub(WIDTH + i))

    return b.build(), (s, x3, x7, ph)
