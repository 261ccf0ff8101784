"""The shared launch path of the port's CUDA kernels (``ops/_launch.py``):
what it does before any library exists.  The launches themselves, on the
caller's stream and under CUDA-graph capture, are held on the card in
``tests/test_torch_cuda.py``."""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import ctypes
import inspect

import pytest
import torch

from opticalflow_tpu_torch.ops import (_launch, corr_cuda, fused_warpcorr,
                                       gather)
from opticalflow_tpu_torch.ops._launch import Kernel, needs_grad

WRAPPERS = {"corr_cuda": (corr_cuda, "correlation_cuda"),
            "fused_warpcorr": (fused_warpcorr, "fused_warp_corr_cuda"),
            "gather": (gather, "row_gather_cuda")}


def test_kernel_binds_nothing_until_it_is_loaded(monkeypatch):
    loaded = []

    class Lib:
        @staticmethod
        def sym(*args):
            return 0

    def fake_load_library(name):
        loaded.append(name)
        return Lib

    monkeypatch.setattr(_launch, "load_library", fake_load_library)
    k = Kernel("some_source", "sym", [ctypes.c_void_p, ctypes.c_int])
    assert k.fn is None and loaded == []
    fn = k.load()
    assert loaded == ["some_source"] and k.fn is fn
    # the device index and the stream handle close every entry point
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert k.load() is fn and loaded == ["some_source"]   # bound once


def test_refused_launch_raises_with_the_symbol_and_the_error():
    k = Kernel("some_source", "sym", [])
    with pytest.raises(RuntimeError, match=r"sym launch failed: cudaError 9 "
                                           r"on cuda:1 at shape \(1, 2\)"):
        k.refused(9, 1, "shape (1, 2)")


@pytest.mark.parametrize("grad_enabled,requires,expected",
                         [(True, (False, False), False),
                          (True, (False, True), True),
                          (False, (True, True), False),
                          (True, (), False)])
def test_needs_grad(grad_enabled, requires, expected):
    tensors = [torch.zeros(2).requires_grad_(r) for r in requires]
    with torch.set_grad_enabled(grad_enabled):
        assert needs_grad(*tensors) is expected


def test_raw_stream_prefers_pytorchs_own_accessor():
    fast = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if fast is not None:
        assert _launch.raw_stream is fast
    else:
        assert _launch.raw_stream is _launch._raw_stream_through_object


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_every_wrapper_launches_through_the_shared_path(name):
    """One ``Kernel`` per wrapper; the stream handle is fetched inside the
    call, for the tensors' device, and nothing at module level keeps one."""
    module, fn_name = WRAPPERS[name]
    assert isinstance(module._kernel, Kernel)
    assert module._kernel.fn is None, "a library was loaded on import"
    src = inspect.getsource(getattr(module, fn_name))
    assert "raw_stream(index)" in src and "index = device.index" in src
    assert "torch.cuda.device(" not in src        # the guard lives in C
    assert "current_stream" not in inspect.getsource(module)
    module_level = [line for line in inspect.getsource(module).splitlines()
                    if line and not line[0].isspace()]
    assert not any("raw_stream(" in line for line in module_level)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_every_entry_point_ends_with_device_and_stream(name):
    """The C side of the contract: ``..., int device, void* stream)`` and a
    device guard in every entry point the wrappers bind."""
    from opticalflow_tpu_torch.ops._build import CSRC_DIR
    k = WRAPPERS[name][0]._kernel
    text = (CSRC_DIR / f"{k.library}.cu").read_text()
    start = text.index(f'extern "C" int {k.symbol}(')
    signature = " ".join(text[start:text.index("{", start)].split())
    assert signature.endswith("int device, void* stream)"), signature
    body = text[start:text.index("\n}\n", start)]
    assert "DeviceGuard guard(device);" in body
    assert k._argtypes[-2:] == [ctypes.c_int, ctypes.c_void_p]
    # one ctypes type per C parameter
    assert len(k._argtypes) == signature.count(",") + 1, signature


def test_sweep_variants_still_match_the_kernel_source():
    """``scripts/sweep_corr.py --variants`` edits constants of the
    correlation kernel by their text; each must still be there, once."""
    from opticalflow_tpu_torch.ops._build import CSRC_DIR
    from opticalflow_tpu_torch.scripts import sweep_corr
    text = (CSRC_DIR / "correlation_fwd.cu").read_text()
    for name, subs in sweep_corr.VARIANTS.items():
        for old, new in subs:
            assert text.count(old) == 1, (name, old)
            assert old != new
    # the forced combinations are ones the C entry point accepts
    assert all(t in (0, 16, 32) and 0 <= s <= 8 for t, s in sweep_corr.COMBOS)


def test_fused_sweep_variants_still_match_the_kernel_source():
    """``scripts/sweep_corr.py --fused --variants`` edits the fused
    kernel's constants by their text; the shared header is found beside
    the original source and is part of every library's digest."""
    from opticalflow_tpu_torch.ops import _build
    from opticalflow_tpu_torch.scripts import sweep_corr
    text = (_build.CSRC_DIR / "fused_warp_corr.cu").read_text()
    for name, subs in sweep_corr.FUSED_VARIANTS.items():
        for old, new in subs:
            assert text.count(old) == 1, (name, old)
            assert old != new
    for target in (sweep_corr.CORR, sweep_corr.FUSED):
        source = (_build.CSRC_DIR / f"{target.source}.cu").read_text()
        assert '#include "corr_tile.cuh"' in source
        assert f'extern "C" int {target.symbol}(' in source
        start = source.index(f'extern "C" int {target.symbol}(')
        signature = source[start:source.index("{", start)]
        assert len(target.argtypes) == signature.count(",") + 1
    assert (_build.CSRC_DIR / "corr_tile.cuh") in set(
        _build.CSRC_DIR.glob("*.cu*"))


def test_the_plan_entry_points_mirror_the_launch_entry_points():
    """``corr_fwd_plan`` and ``fused_warp_corr_plan`` take the shape, md,
    dtype, tile, split and device, and write six ints."""
    from opticalflow_tpu_torch.ops._build import CSRC_DIR
    for library, symbol in (("correlation_fwd", "corr_fwd_plan"),
                            ("fused_warp_corr", "fused_warp_corr_plan")):
        text = (CSRC_DIR / f"{library}.cu").read_text()
        start = text.index(f'extern "C" int {symbol}(')
        signature = " ".join(text[start:text.index("{", start)].split())
        assert signature.endswith("int tile, int split, int device, "
                                  "int* plan)"), signature
        assert signature.count(",") + 1 == 10
        body = text[start:text.index("\n}\n", start)]
        assert "write_plan(p, plan);" in body


def test_bwd_sweep_variants_still_match_the_kernel_source():
    """``scripts/sweep_corr.py --bwd --variants`` edits the backward
    kernel's constants by their text; each must still be there, once, and
    the sweep's ctypes must match the entry point."""
    from opticalflow_tpu_torch.ops._build import CSRC_DIR
    from opticalflow_tpu_torch.scripts import sweep_corr
    text = (CSRC_DIR / "correlation_bwd.cu").read_text()
    for name, subs in sweep_corr.BWD_VARIANTS.items():
        for old, new in subs:
            assert text.count(old) == 1, (name, old)
            assert old != new
    start = text.index('extern "C" int corr_bwd(')
    signature = text[start:text.index("{", start)]
    assert len(sweep_corr.BWD.argtypes) == signature.count(",") + 1
    assert sweep_corr.BWD.argtypes == corr_cuda._bwd_kernel._argtypes
    # the forced plans are ones the wrapper's range checks accept
    for tile, split in sweep_corr.BWD_COMBOS:
        corr_cuda._check_bwd_plan(tile, split)


def test_bwd_entry_points_take_the_tile_and_the_split():
    """``corr_bwd`` and ``corr_bwd_plan`` take the shape, md, dtype, tile,
    split and device; the plan writes nine ints, the occupancy among them,
    and both switch to the device first."""
    from opticalflow_tpu_torch.ops._build import CSRC_DIR
    text = (CSRC_DIR / "correlation_bwd.cu").read_text()
    for symbol, tail, nargs in (
            ("corr_bwd", "int tile, int split, int device, void* stream)",
             15),
            ("corr_bwd_plan", "int tile, int split, int device, int* plan)",
             10)):
        start = text.index(f'extern "C" int {symbol}(')
        signature = " ".join(text[start:text.index("{", start)].split())
        assert signature.endswith(tail), signature
        assert signature.count(",") + 1 == nargs
        body = text[start:text.index("\n}\n", start)]
        assert "DeviceGuard guard(device);" in body
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in text
    assert "plan[7] = p.per_sm; plan[8] = p.regs;" in text
    assert len(corr_cuda._bwd_kernel._argtypes) == 15


def test_bwd_launch_plan_binds_the_plan_entry_point_once(monkeypatch):
    """``bwd_launch_plan`` goes through ``corr_bwd_plan`` of the kernel's
    own library and reports what it wrote, the blocks an SM holds and the
    registers included."""
    calls = []

    def fake_plan(b, c, h, w, md, code, tile, split, device, plan):
        calls.append((b, c, h, w, md, code, tile, split, device))
        for i, v in enumerate((4, 16, 9, 4, 5, 144, 32256, 4, 96)):
            plan[i] = v
        return 0 if split != 2 else 1

    class Lib:
        corr_bwd_plan = staticmethod(fake_plan)

    loaded = []
    monkeypatch.setattr(corr_cuda, "_plan_fns", {})
    monkeypatch.setattr(corr_cuda, "load_library",
                        lambda name: loaded.append(name) or Lib)
    p = corr_cuda.bwd_launch_plan(3, 17, 9, 45, torch.bfloat16, tile=16,
                                  split=4)
    assert loaded == ["correlation_bwd"]
    assert calls == [(3, 17, 9, 45, 4, 1, 16, 4, 0)]
    assert p == {"tile": [4, 16], "tiles": 9, "split": 4,
                 "channels_per_split": 5, "threads": 144,
                 "smem_bytes": 32256, "blocks_per_sm": 4, "registers": 96,
                 "grid": [9, 4, 6]}
    with pytest.raises(ValueError, match="cudaError 1"):
        corr_cuda.bwd_launch_plan(3, 17, 9, 45, torch.float32, split=2)
    assert loaded == ["correlation_bwd"]          # bound once
    assert len(calls) == 2


@pytest.mark.parametrize("tile,split", [(8, 0), (64, 0), (-16, 0), (0, -1),
                                        (0, 65), (32, 1.5), (16, "2")])
def test_bwd_forced_plan_is_range_checked_before_any_build(monkeypatch,
                                                           tile, split):
    """A tile or split the kernel does not take raises in Python, before a
    library is built or loaded, in the wrapper and in the plan alike."""
    def no_build(*a, **k):
        raise AssertionError("a refused plan reached the library")
    monkeypatch.setattr(corr_cuda._bwd_kernel, "load", no_build)
    monkeypatch.setattr(corr_cuda, "_plan_fns", {})
    monkeypatch.setattr(corr_cuda, "load_library", no_build)
    with pytest.raises(ValueError, match="tile in"):
        corr_cuda.bwd_launch_plan(1, 8, 8, 8, torch.float32, tile=tile,
                                  split=split)
    f = torch.zeros(1, 8, 8, 8)
    with pytest.raises(ValueError, match="tile in"):
        corr_cuda.correlation_bwd_cuda(f, f, torch.zeros(1, 81, 8, 8),
                                       tile=tile, split=split)
