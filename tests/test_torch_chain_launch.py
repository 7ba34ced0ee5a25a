"""The decode chain's launch rule, read from the CUDA sources (CPU only).

K1, K2, K5, K6 and K7 are programmatic dependent launches
(csrc/common.cuh `launch_chain`): each may start while the kernel before it
runs. So each kernel body waits on the grid dependency (`pdl_wait()`) once,
names none of its activation arguments (what the chain writes: its inputs,
outputs, caches, positions) before that wait, and lets the next kernel
start (`pdl_launch_dependents()`) right after it. A kernel that reads its
input from its first instruction (K4) must not be launched that way.
"""
import re
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "faster_qwen3_tts_tpu_torch" / "csrc"
CHAIN_FILES = ("decode_attention.cu", "int8_gemv.cu", "glue.cu")

# kernel -> (file, the arguments the chain writes)
CHAIN = {
    "decode_attn_kernel": ("decode_attention.cu", ("q", "k", "v", "mask", "out")),
    "int8_gemv_kernel": ("int8_gemv.cu", ("x", "y")),
    "add_rms_norm_kernel": ("glue.cu", ("x", "res", "sum", "out")),
    "qk_norm_rope_kv_kernel": ("glue.cu", ("q", "k", "v", "cos", "sin", "kc", "vc", "write_pos", "q_out")),
    "silu_mul_kernel": ("glue.cu", ("g", "u", "out")),
}


def _code(name: str) -> str:
    """A source without its comments."""
    text = (CSRC / name).read_text()
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)


def _matched(text: str, start: int, open_ch: str, close_ch: str) -> int:
    """The index just past the bracket that closes the one at `start`."""
    depth = 0
    for i in range(start, len(text)):
        depth += text[i] == open_ch
        depth -= text[i] == close_ch
        if depth == 0:
            return i + 1
    raise AssertionError("unbalanced brackets")


def _kernels(code: str) -> dict:
    """name -> (parameter list, body) of every __global__ function."""
    out = {}
    for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(", code):
        params_end = _matched(code, m.end() - 1, "(", ")")
        body_start = code.index("{", params_end)
        out[m.group(1)] = (code[m.end():params_end - 1], code[body_start:_matched(code, body_start, "{", "}")])
    return out


def test_the_chain_files_hold_only_chain_kernels():
    found = {name for f in CHAIN_FILES for name in _kernels(_code(f))}
    assert found == set(CHAIN)


@pytest.mark.parametrize("kernel", list(CHAIN))
def test_kernel_waits_once_before_it_reads_the_chain(kernel):
    source, written = CHAIN[kernel]
    params, body = _kernels(_code(source))[kernel]
    for arg in written:
        assert re.search(rf"\b{arg}\b", params), f"{kernel} has no argument {arg}"
    assert body.count("pdl_wait();") == 1 and body.count("pdl_launch_dependents();") == 1
    wait = body.index("pdl_wait();")
    after = body[wait + len("pdl_wait();"):]
    assert after.lstrip().startswith("pdl_launch_dependents();"), "the next kernel starts right after the wait"
    prologue = body[:wait]
    named = [arg for arg in written if re.search(rf"(?<![\w.]){arg}\b", prologue)]  # not threadIdx.x
    assert not named, f"{kernel} names {named} before its wait"


@pytest.mark.parametrize("source", CHAIN_FILES)
def test_chain_files_launch_only_through_launch_chain(source):
    code = _code(source)
    assert "<<<" not in code and "launch_cluster" not in code and "cudaLaunchKernelEx" not in code
    assert "launch_chain<" in code


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.glob("*.cu")))
def test_every_chained_launch_is_of_a_kernel_that_waits(source):
    """A kernel launched by `launch_chain` waits before it reads: K4 and
    K3, which do not, keep launches that start after the kernel before
    them has completed."""
    code = _code(source)
    kernels = _kernels(code)
    for name in re.findall(r"launch_chain<\s*(\w+)", code):
        assert "pdl_wait();" in kernels[name][1], f"{source}: {name} is chained but never waits"
