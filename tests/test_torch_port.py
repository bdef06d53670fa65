"""Ground rules of the PyTorch/CUDA port that hold on any machine: it imports
nothing of JAX or of the JAX package, its entry points refuse to run on the
CPU unasked, and its modules import without building anything."""

import ast
import pathlib

import pytest
import torch

import deepgemm_tpu_torch as dgt
from deepgemm_tpu_torch.heuristics.configs import (get_gemm_config, get_sm90_config,
                                                   sm90_smem_bytes, widen_smem_bytes)
from deepgemm_tpu_torch.kernels import common
from deepgemm_tpu_torch.models import convert, transformer
from deepgemm_tpu_torch.runtime import build

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / 'deepgemm_tpu_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for name in _imported_modules(path):
        top = name.split('.')[0]
        assert top not in ('jax', 'jaxlib', 'deepgemm_tpu'), f'{path} imports {name}'


def test_entry_points_refuse_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device is valid')
    cfg = transformer.ModelConfig(vocab=16, hidden=128, num_layers=1, num_heads=1,
                                  head_dim=64, num_experts=2, topk=1,
                                  moe_intermediate=128)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        transformer.init_params(cfg)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        convert.params_from_jax({'w': torch.zeros(2).numpy()})
    with pytest.raises(RuntimeError, match='no CUDA device'):
        dgt.resolve_device()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        dgt.get_num_sms()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        dgt.ContinuousBatcher(max_slots=1, max_pages_per_seq=1, num_blocks=1, block_kv=64,
                              num_heads=1, head_dim=64, index_heads=1, index_dim=32, topk=1,
                              embed_fn=None)


def test_kernel_libraries_are_keyed_by_source_hash(tmp_path, monkeypatch):
    monkeypatch.setenv('DGT_BUILD_DIR', str(tmp_path))
    paths = {name: build.library_path(name) for name in build.SOURCES}
    assert all(p.parent == tmp_path for p in paths.values())
    assert len({p.name for p in paths.values()}) == len(build.SOURCES)
    assert not any(p.exists() for p in paths.values())   # nothing built at import


@pytest.mark.parametrize('m,n,groups,block_n', [
    (4096, 4096, 1, 128),      # 2048 blocks at 128 wide
    (128, 4096, 1, 64),        # 64 blocks at 128 wide: too few for 132 SMs
    (40, 4096, 256, 128),      # 256 groups of 40 rows
    (40, 7168, 256, 128),
    (32768, 4096, 1, 128),     # a tall dense problem
    (256, 7168, 1, 64),        # 4 x 56 blocks at 128 wide: too few
    (4096, 7168, 256, 128),    # the k-grouped L1 wgrad of the training step
])
def test_tile_chooser(m, n, groups, block_n):
    cfg = get_gemm_config(m, n, groups, num_sms=132)
    assert cfg.block_n == block_n and cfg.block_m == 64
    assert cfg.smem_bytes <= 232448


_SM90_CASES = [
    (4096, 4096, 1, 2, 128, 5),       # phase 3: 1024 tiles
    (128, 4096, 1, 2, 64, 8),         # phase 3: 32 tiles of 128 rows would leave SMs idle
    (2048, 49152, 1, 2, 128, 5),      # phase 6: qkv fwd
    (2048, 7168, 1, 2, 128, 5),       # phase 6: o fwd, qkv dgrad
    (2048, 16384, 1, 2, 128, 5),      # phase 6: o dgrad
    (7168, 16384, 1, 4, 128, 4),      # phase 6: o wgrad, f32 out
    (49152, 7168, 1, 4, 128, 4),      # phase 6: qkv wgrad, f32 out
    (7168, 2048, 256, 2, 128, 5),     # phase 6: k-grouped L2 wgrad, bf16 out
    (4096, 7168, 256, 2, 128, 5),     # phase 6: k-grouped L1 wgrad, bf16 out
    (7168, 2048, 256, 4, 128, 4),     # phase 10: k-grouped flat, f32 out
    (16, 7168, 1, 2, 64, 8),          # phase 10: planar FP4 B at m 16
    (4096, 7168, 1, 2, 128, 5),       # phase 10: planar FP4 B at m 4096
]
# The contiguous kernel's items (256 experts): (form, operand bytes, mk
# alignment) after the shape, rows and stages. At alignment 128 its tiles
# are 128 rows (one pass over each expert's weights), at 64 they are 64;
# e4m3 stages carry scales, the e4m3 NN form two k-major B tiles, the dual-B
# form 256 x 64 tiles with two B tiles a stage; its ring is held at 4
# stages (CONTIGUOUS_MAX_STAGES), which every form's shared memory holds.
_CONTIGUOUS_CASES = [
    (32768, 4096, 256, 2, 128, 4, 'nt', 1, 128),    # phase 6: L1 fwd
    (32768, 7168, 256, 2, 128, 4, 'nt', 1, 128),    # phase 6: L2 fwd, L1 dgrad
    (32768, 4096, 256, 2, 128, 4, 'nt', 2, 128),    # phase 9's layout, bf16
    (32768, 4096, 256, 2, 128, 4, 'nn', 1, 128),    # phase 10: NN e4m3 (transposed in smem)
    (32768, 7168, 256, 2, 128, 4, 'nn', 2, 128),    # phase 10: NN bf16 (wgmma's transposed B)
    (32768, 4096, 256, 2, 256, 4, 'dual', 1, 128),  # phase 9: dual-B e4m3
    (32768, 7168, 256, 2, 256, 4, 'dual', 2, 128),  # phase 9: dual-B bf16
    (32768, 4096, 256, 2, 64, 4, 'nt', 1, 64),      # mk alignment 64: 64-row tiles
    (32768, 4096, 256, 2, 64, 4, 'nt', 2, 64),
    (32768, 4096, 256, 2, 64, 4, 'nn', 1, 64),
]


@pytest.mark.parametrize('m,n,groups,out_bytes,block_m,stages,form,elem,alignment', [
    *(pytest.param(*case, None, 1, 128, id='-'.join(map(str, case))) for case in _SM90_CASES),
    *(pytest.param(*case, id='contiguous-' + '-'.join(map(str, case))) for case in _CONTIGUOUS_CASES),
])
def test_sm90_tile_chooser(m, n, groups, out_bytes, block_m, stages, form, elem, alignment):
    """The Hopper mainloop's tile at the chip run's shapes: 128 columns (the
    dual-B form 64), the rows intended, the stages intended (as many as a
    block's shared memory holds beside the epilogue's staging tile, the
    k-grouped group table and the transposed B tiles, at most 8; the
    contiguous kernel at most 4), a persistent grid of at most one block an
    SM (the contiguous kernel's items are its tiles, whatever their
    groups)."""
    k_grouped = form is None and groups > 1
    cfg = get_sm90_config(m, n, groups, out_bytes, num_sms=132, k_grouped=k_grouped,
                          contiguous=form, elem=elem, mk_alignment=alignment)
    block_n = 64 if form == 'dual' else 128
    assert (cfg.block_m, cfg.block_n, cfg.num_stages) == (block_m, block_n, stages)
    table = groups if k_grouped else 0
    smem = lambda st: sm90_smem_bytes(block_m, st, out_bytes, table, block_n,
                                      b_tiles=2 if form == 'dual' else 1, scaled=elem == 1,
                                      transposed_b=form == 'nn' and elem == 1)
    assert cfg.smem_bytes == smem(stages) <= 232448
    if stages < (4 if form else 8):
        assert smem(stages + 1) > 232448
    tiles = -(-m // block_m) * -(-n // block_n) * (1 if form else groups)
    assert cfg.num_sms == min(tiles, 132)


# The masked kernel's items at the chip run's shapes: (max_m, n, groups,
# output bytes, operand bytes, rows, stages that fit). 64-row tiles (one
# consumer warpgroup) where a group's rows fit, else 128; the ring is held
# at MASKED_MAX_STAGES (3) where a block holds it (a 128-row tile with e4m3
# operands widened to bf16 and an f32 output holds 2).
_MASKED_CASES = [
    (40, 4096, 256, 2, 1, 64, 5),       # phase 4: the decode's L1, fp8
    (40, 7168, 256, 2, 2, 64, 8),       # phase 4: L2, bf16
    (4096, 128, 128, 2, 1, 128, 3),     # phase 9: fp8_einsum bhr,hdr->bhd
    (4096, 128, 128, 4, 1, 128, 2),     # phase 9: fp8_bmm with c, the f32 instance
    (320, 4096, 32, 2, 1, 128, 3),      # phase 11: #12 at 8 ranks of cap 40, fp8
    (320, 4096, 32, 2, 2, 128, 6),      # phase 11: #12, bf16
    (36, 256, 4, 2, 1, 64, 5),          # #12 at 2 ranks of cap 18
    (17, 256, 3, 2, 1, 64, 5),
    (64, 200, 3, 2, 1, 64, 5),
    (65, 200, 3, 2, 1, 128, 3),
    (200, 202, 3, 4, 1, 128, 2),
]


@pytest.mark.parametrize('m,n,groups,out_bytes,elem,block_m,fit', _MASKED_CASES)
def test_masked_tile_chooser(m, n, groups, out_bytes, elem, block_m, fit):
    """The masked kernel's tile and ring (heuristics/configs.py, masked):
    64 rows at max_m <= 64, 128 above, MASKED_MAX_STAGES stages where a
    block's shared memory holds them (``fit``: as many as it holds), a grid
    of at most one block an SM; its plan is the widening kernel's
    (widen_smem_bytes), both operands of ``elem`` bytes."""
    from deepgemm_tpu_torch.heuristics.configs import MASKED_MAX_STAGES, widen_smem_bytes
    cfg = get_sm90_config(m, n, groups, out_bytes, num_sms=132, masked=True, elem=elem)
    stages = min(MASKED_MAX_STAGES, fit)
    assert (cfg.block_m, cfg.block_n, cfg.num_stages) == (block_m, 128, stages)
    smem = lambda st: widen_smem_bytes(block_m, st, out_bytes, elem, elem)
    assert cfg.smem_bytes == smem(stages) <= smem(fit) <= 232448
    if fit < 8:
        assert smem(fit + 1) > 232448
    assert cfg.num_sms == min(-(-m // block_m) * -(-n // 128) * groups, 132)
    assert get_sm90_config(m, n, groups, out_bytes, num_sms=132, masked=True, elem=elem,
                           max_stages=fit).num_stages == fit


def test_plain_versions_switch_is_explicit_and_scoped():
    """The switch is off unless a caller opens it, nests, and closes again
    on the way out of an error; CPU tensors take the plain versions either
    way, and devices other than the CPU and CUDA raise."""
    assert not common._plain_on_cuda
    assert common.use_plain(torch.zeros(2))
    with pytest.raises(KeyError):
        with dgt.plain_versions():
            with dgt.plain_versions():
                assert common._plain_on_cuda
            assert common._plain_on_cuda
            raise KeyError
    assert not common._plain_on_cuda
    with pytest.raises(ValueError):
        common.use_plain(torch.zeros(2, device='meta'))


def test_mega_public_names():
    """The public names of the JAX package's mega MoE and FP4 surface
    (deepgemm_tpu/__init__.py:85-110) exist in the port."""
    for name in ('per_token_cast_to_fp4', 'transpose_packed_fp4', 'cast_back_from_fp4',
                 'pack_fp4_planar', 'unpack_fp4_planar', 'repack_fp4_to_planar',
                 'fp8_fp4_mega_moe', 'bf16_mega_moe', 'SymmBuffer',
                 'get_symm_buffer_for_mega_moe', 'transform_weights_for_mega_moe',
                 'get_symm_buffer_size_for_mega_moe', 'get_token_alignment_for_mega_moe',
                 'get_ring_limit_for_mega_moe', 'pack_mega_weights', 'MegaPackedWeights'):
        assert callable(getattr(dgt, name)), name
    assert dgt.get_symm_buffer_for_mega_moe is dgt.SymmBuffer
    assert 'mega_local' in build.SOURCES


def test_dual_b_tile_fits_a_block():
    """The dual-B tile of the Hopper mainloop (256 rows, room for two B
    tiles a stage) holds 4 stages in a block's shared memory at 64 columns,
    e4m3 and bf16; at 128 columns e4m3 would hold only 2."""
    for elem in (1, 2):
        cfg = get_sm90_config(32768, 4096, 256, contiguous='dual', elem=elem, num_sms=132)
        assert (cfg.block_m, cfg.block_n, cfg.num_stages) == (256, 64, 4)
        assert cfg.smem_bytes <= 232448
    assert sm90_smem_bytes(256, 2, 2, 0, 128, b_tiles=2) <= 232448
    assert sm90_smem_bytes(256, 3, 2, 0, 128, b_tiles=2) > 232448


def test_einsum_hc_public_names():
    """The JAX package's einsum, HyperConnection, skip-head-mid and testing
    names (deepgemm_tpu/__init__.py, deepgemm_tpu/testing/__init__.py)."""
    for name in ('einsum', 'fp8_einsum', 'fp8_bmm', 'tf32_hc_prenorm_gemm',
                 'fp8_gemm_nt_skip_head_mid'):
        assert callable(getattr(dgt, name)), name
    for name in ('calc_diff', 'count_bytes', 'assert_bitwise_equal', 'bench_profiled',
                 'get_arch_major', 'get_device_core_count', 'test_filter'):
        assert callable(getattr(dgt.testing, name)), name
    assert 'hc_prenorm' in build.SOURCES


# The dense forms on bf16 products (the widening kernel): (m, n, output
# bytes, operand bytes a and b, rows, columns, stages). 128 x 128 tiles where
# they fill the SMs; 64 rows, and then 64 columns, where they would not.
_WIDEN_CASES = [
    (4096, 4096, 2, 1, 1, 128, 128, 3),     # phase 10: 'dequant' at 4096 x 4096 x 7168
    (4096, 4096, 4, 1, 1, 128, 128, 2),     # the same into f32 (two widened B tiles, f32 staging)
    (4096, 4096, 2, 1, 2, 128, 128, 3),     # phase 10: FP4 at gran 32 (e4m3 x bf16)
    (4096, 4096, 2, 2, 1, 128, 128, 2),     # bf16 x e4m3
    (128, 4096, 2, 1, 1, 64, 64, 8),        # phase 10: 'dequant' at the decode shape
    (256, 7168, 2, 1, 2, 64, 128, 5),       # 64-row tiles fill the SMs at 128 columns
]


@pytest.mark.parametrize('m,n,out_bytes,elem_a,elem_b,block_m,block_n,stages', _WIDEN_CASES)
def test_widen_tile_chooser(m, n, out_bytes, elem_a, elem_b, block_m, block_n, stages):
    """The widening kernel's tile and ring: as many stages as a block's
    shared memory holds beside the staging tiles and the widened B tiles, at
    most 8, and a persistent grid of at most one block an SM."""
    cfg = get_sm90_config(m, n, 1, out_bytes, num_sms=132, widen=(elem_a, elem_b))
    assert (cfg.block_m, cfg.block_n, cfg.num_stages) == (block_m, block_n, stages)
    smem = lambda st: widen_smem_bytes(block_m, st, out_bytes, elem_a, elem_b, block_n)
    assert cfg.smem_bytes == smem(stages) <= 232448
    if stages < 8:
        assert smem(stages + 1) > 232448
    assert cfg.num_sms == min(-(-m // block_m) * -(-n // block_n), 132)


# What the port does not have of the JAX package's public names: the legacy
# pure-XLA tier with its two ``_tl`` names and the persistent kernel cache
# (ROADMAP Queue 1 item 3). Anything else the JAX package exports, the port
# exports too.
NOT_PORTED = {'legacy', 'm_grouped_bf16_gemm_nt_contiguous_tl',
              'm_grouped_bf16_gemm_nn_contiguous_tl', 'kernel_cache', 'init_persistent_cache',
              'init'}


def test_public_names_match_the_jax_package():
    import deepgemm_tpu as dg
    public = lambda module: {n for n in dir(module) if not n.startswith('_')}
    assert public(dg) - public(dgt) == NOT_PORTED
    for name in ('fp8_fp4_gemm_nn', 'fp8_gemm_tt', 'bf16_gemm_tn', 'cublaslt_gemm',
                 'm_grouped_fp8_fp4_gemm_nn_contiguous', 'm_grouped_bf16_gemm_nn_contiguous',
                 'k_grouped_fp8_gemm_nt_contiguous', 'transform_sf_into_required_layout',
                 'set_mk_alignment_for_contiguous_layout', 'fp8_m_grouped_gemm_nt_masked'):
        assert callable(getattr(dgt, name)), name
    assert 'dense_dequant' in build.SOURCES
