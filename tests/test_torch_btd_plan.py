"""K-BTD's rule for the regime, instance and threads of a launch
(``ops/cuda/btd_solve.team``) at every D, with the shared memory of an H100
and of a smaller card: the regime and instance each D takes, the block
kernel's tiles covering its rows in a team of whole warps, the scratch
boundary, and refusal of what cannot fit.  The kernel library's own plan,
which decides the launch, is held equal to this rule on the card
(``tests/test_torch_cuda.py``).
"""
import pytest

from dgpmp2_tpu_torch.ops.cuda import btd_solve as k

H100_OPTIN = 232448   # opt-in shared bytes a block
SMALL_OPTIN = 101376  # a card with 99 KB a block
OPTINS = (H100_OPTIN, SMALL_OPTIN)


@pytest.mark.parametrize("optin", OPTINS)
def test_team_takes_every_d_in_its_regime(optin):
    seen = set()
    for d in range(1, 81):
        regime, instance, threads = k.team(d, optin)
        want = ("lane" if d <= 16 else "wide" if d <= 32
                else "block" if k.block_elems(d) * 8 <= optin else "scratch")
        assert regime == want, (d, regime)
        assert threads % 32 == 0
        if regime == "lane":
            assert (instance, threads) == (d, 32)
        elif regime == "wide":
            # The narrowest register width that holds D, a warp a problem.
            assert instance == min(w for w in k.WIDE_WIDTHS if w >= d)
            assert threads == 32
        elif regime == "block":
            assert instance == k.CHUNK
        seen.add((regime, instance))
    # Every wide instance the library builds is taken by some D.
    assert {i for r, i in seen if r == "wide"} == set(k.WIDE_WIDTHS)


def test_block_tiles_cover_each_row_in_whole_warps():
    """Past D = 32, block_tiles tiles of CHUNK cover each row of 2 D + 1,
    TILE_ROWS rows a thread; the team is the fewest whole warps that hold
    every tile, at most BLOCK_MAX_THREADS."""
    for d in range(33, 76):
        regime, _, threads = k.team(d, H100_OPTIN)
        nh, rows = k.block_tiles(d), -(-d // k.TILE_ROWS)
        assert regime == "block"
        assert nh * k.CHUNK >= 2 * d + 1 > (nh - 1) * k.CHUNK
        assert rows * nh <= threads < rows * nh + 32
        assert threads <= k.BLOCK_MAX_THREADS


@pytest.mark.parametrize("optin,top", [(H100_OPTIN, 75), (SMALL_OPTIN, 50)])
def test_team_keeps_the_scratch_boundary_of_the_shared_memory(optin, top):
    """The block kernel runs where the global-scratch kernel's rows fit the
    opt-in shared memory, the scratch kernel past it."""
    assert k.team(top, optin)[0] == "block"
    assert k.team(top + 1, optin)[0] == "scratch"
    assert k.team(top + 1, optin)[2] == k.SCRATCH_THREADS


def test_team_refuses_what_cannot_fit():
    with pytest.raises(ValueError):
        k.team(0, H100_OPTIN)
    # With the shared memory of a larger card, D = 80 would need 297
    # threads (27 row triples of 11 tiles), past the kernel's 256.
    with pytest.raises(ValueError, match="threads"):
        k.team(80, 10 * H100_OPTIN)
    # Where even the scratch kernel's rows do not fit, the rows go to
    # device memory: no refusal.
    assert k.team(40, 40000)[0] == "scratch"
