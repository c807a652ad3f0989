"""Each kernel's work count against a hand count at a small shape, and
the kernel names it reads in a trace."""
import pytest

from bench_port import peaks, spec

DIMS = {"views": 2, "height": 8, "width": 8, "channels": 4}


def test_view_fuse_float32():
    # sum of in*out over the ten layers: 19,320; of in*out + out: 19,574
    flops, nbytes, peak = spec.work("view_fuse").cost(10, 1, "float32",
                                                      **DIMS)
    assert flops == 2 * 10 * (2 * 19320 - 1 * 140 * 64)
    assert nbytes == 4 * (2 * 10 * 72 + 10 * 65 + 2 * 10 * 33) + 4 * 10 \
        + 4 * 19574
    assert peak == peaks.FLOPS["float32"]


def test_view_fuse_bfloat16_two_launches():
    flops, nbytes, peak = spec.work("view_fuse").cost(10, 2, "bfloat16",
                                                      **DIMS)
    assert flops == 2 * 10 * (2 * 19320 - 140 * 64)
    assert nbytes == 2 * 2750 + 4 * 10 + 2 * 2 * 19574
    assert peak == peaks.FLOPS["bfloat16"]


@pytest.mark.parametrize("dtype,es", [("float32", 4), ("bfloat16", 2)])
def test_gather(dtype, es):
    flops, nbytes, _ = spec.work("epipolar_gather").cost(5, 1, dtype,
                                                         **DIMS)
    maps = 2 * (8 * 8 * 3 + 2 * 2 * 2 * 4) * es          # 224 values a view
    outs = 2 * 5 * (7 * es + 4 * 4)                      # rgb_feats, ray_feats
    assert nbytes == maps + 2 * 5 * (8 + 1) + outs
    assert flops == 2 * 5 * (3 + 8) * 8


@pytest.mark.parametrize("dtype,es,per", [("float32", 4, 11),
                                          ("bfloat16", 2, 12)])
def test_gather_backward(dtype, es, per):
    flops, nbytes, peak = spec.work("epipolar_gather_backward").cost(
        5, 3, dtype, **DIMS)
    ups = 2 * 5 * (8 + 1 + 7 * es + 4 * 4)              # xy, valid, d_rgb, d_ray
    grads = 3 * 2 * 2 * (2 * 2 * 4) * es                 # 3 launches, 2 maps
    assert nbytes == ups + grads
    assert flops == 2 * 5 * 2 * 4 * per
    assert peak == peaks.FLOPS["float32"]


@pytest.mark.parametrize("kernel,name,hit", [
    ("view_fuse", "void (anonymous namespace)::view_fuse_kernel(float "
     "const*, float*)", True),
    ("view_fuse", "void (anonymous namespace)::view_fuse_bf16_kernel("
     "__nv_bfloat16 const*)", True),
    ("epipolar_gather", "void (anonymous namespace)::gather_kernel<true, "
     "float>(float const*)", True),
    ("epipolar_gather", "void (anonymous namespace)::xy_grad_kernel<float>("
     "float const*)", False),
    ("epipolar_gather_backward", "void (anonymous namespace)::index_kernel<"
     "false, float, float>(float const*)", True),
    ("epipolar_gather_backward", "void (anonymous namespace)::sync_pull::"
     "pull_kernel<true>(float const*)", True),
    ("epipolar_gather_backward", "void (anonymous namespace)::gather_kernel"
     "<true, float>(float const*)", False)])
def test_kernel_names(kernel, name, hit):
    assert bool(spec.work(kernel).PATTERN.search(name)) is hit
