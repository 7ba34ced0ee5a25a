"""A configuration's model module (`portbench/models`): Qwen3-TTS's gives the
tree and the reference the benchmark had before the module existed, and a
configuration of another architecture, added in a copy of the benchmark as
a configuration file and a module of its own, is drawn, judged, counted and
read by the unedited harness, judge, taps and readers."""
from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from portbench import models, voices
from portbench.reference import model as ref_lib
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 11
# Read at tiny.py's size on the tree before the model modules existed (the same seed and inputs, one
# torch thread as `conftest.py` sets: more threads sum the x-vector's projection in another order):
# the tree's digest, and of the reference's talker and predictor logits their float64 sums, largest
# magnitude and a few entries, and of its streamed audio the chunk lengths and sum.
PINNED = {
    "base": {"tree": "bcf3e358bcbbeb1eb376c9a866882037c54192d2b590768cc8f905a520de756a",
             "sums": (-96.27757558957819, 48.60580308116414), "max": 4.280913352966309,
             "talker_row3": [0.998390793800354, -0.6549344658851624, -0.38424667716026306, 1.9593260288238525],
             "pred_2_5": [-0.45643502473831177, 1.0204567909240723, -1.8806155920028687]},
    "custom_voice": {"tree": "bcf3e358bcbbeb1eb376c9a866882037c54192d2b590768cc8f905a520de756a",
                     "sums": (-386.5841453433386, -113.34134427617937), "max": 4.175604343414307,
                     "talker_row3": [1.2555992603302002, -1.4019485712051392, -0.44446372985839844,
                                     0.22019298374652863],
                     "pred_2_5": [0.009990813210606575, 0.9007031321525574, -0.46239936351776123]},
}
AUDIO = ([7125, 3840], 0.006429583692209917)


def _leaves(node, path=()):
    if isinstance(node, dict):
        for k in sorted(node, key=str):
            yield from _leaves(node[k], path + (str(k),))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), node


def tree_digest(tree) -> str:
    """sha256 over every leaf's path, dtype, shape and bytes, in path order."""
    h = hashlib.sha256()
    for path, t in _leaves(tree):
        h.update(path.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("model_type", ["base", "custom_voice"])
def test_qwen3_tts_gives_the_tree_and_reference_it_had(model_type):
    cfg = tiny.tiny_cfg(model_type)
    mod = models.of(cfg)
    assert mod.__name__ == "portbench.models.qwen3_tts" and mod.Reference is ref_lib.Reference
    tree = mod.make_tree(cfg, SEED, "cpu")
    pin = PINNED[model_type]
    assert tree_digest(tree) == pin["tree"]
    ref = mod.Reference(tree, cfg)
    frames = torch.randint(0, 64, (6, 16), generator=torch.Generator().manual_seed(3))
    inputs = {"text": "Abc de", "language": "English"}
    if model_type == "base":
        kind = voices.of({"voices": 2})
        inputs.update(kind.reference(kind.draw({"voices": 2}, SEED, cfg), {"voice": 1}))
    else:
        inputs.update(voices.of({"speakers": ["ryan"]}).reference(["ryan"], {"speaker": "ryan"}))
    with torch.no_grad():
        tl, pl = ref.logits(inputs, frames)
        audio = ref.stream_audio(frames, [4, 2])
    assert (float(tl.double().sum()), float(pl.double().sum())) == pytest.approx(pin["sums"], rel=1e-6)
    assert float(tl.abs().max()) == pytest.approx(pin["max"], rel=1e-6)
    assert tl[3, :4].tolist() == pytest.approx(pin["talker_row3"], abs=1e-6)
    assert pl[2, 5, :3].tolist() == pytest.approx(pin["pred_2_5"], abs=1e-6)
    assert [a.shape[0] for a in audio] == AUDIO[0]
    assert float(torch.cat(audio).double().sum()) == pytest.approx(AUDIO[1], rel=1e-6)


def test_an_unknown_or_malformed_model_is_refused():
    with pytest.raises(ModuleNotFoundError):
        models.of({"model": "no_such_model"})
    with pytest.raises(ValueError):
        models.of({"model": "../reference"})


TOY = textwrap.dedent("""
    import json, sys
    from pathlib import Path

    import numpy as np
    import torch

    root = Path(sys.argv[1])
    sys.path[:0] = [str(root), sys.argv[3]]  # the copy's benchmark first, then the program
    torch.set_num_threads(1)
    from faster_qwen3_tts_tpu_torch.engine import core
    from portbench import harness, judge, models, readers, taps as taps_lib, voices
    from portbench.models import qwen3_tts
    from portbench.traffic import mix

    assert Path(harness.__file__).parent == root / "portbench", harness.__file__
    res = harness.resolve("toy.cell", bench_root=root)
    cfg, workload = res["cfg"], res["workload"]
    mod = models.of(cfg)
    assert Path(mod.__file__) == root / "portbench" / "models" / "toy_moe.py", mod.__file__
    seed, device, sampling = int(sys.argv[2]), torch.device("cpu"), workload["sampling"]
    ref = mod.Reference(mod.make_tree(cfg, seed, device), cfg)
    params = workload["traffic_params"]
    kind = voices.of(params)
    vs = kind.draw(params, seed, cfg)


    def greedy(inputs, T):
        # the reference's own greedy frames: codebook 0 from the processed talker logits, then each
        # further codebook from the code predictor's logits given the ones before it
        frames = torch.zeros(0, 16, dtype=torch.long)
        for t in range(T):
            frames = torch.cat([frames, torch.zeros(1, 16, dtype=torch.long)])  # row t: filled below
            tl, _ = ref.logits(inputs, frames)
            frames[t, 0] = mod.processed(tl, frames[:, 0], cfg, sampling)[t].argmax()
            for c in range(15):
                _, pl = ref.logits(inputs, frames)
                frames[t, c + 1] = pl[t, c].argmax()
        return frames


    records = []
    with torch.no_grad():
        for req in mix.make(params, seed, 2):
            inputs = judge.request_inputs({"req": req}, vs, kind)
            frames = greedy(inputs, req["frames"])
            steps = [4, req["frames"] - 4]
            audio = ref.stream_audio(frames, steps, inputs=inputs)
            records.append({"req": req, "frames": [frames.numpy()], "audio": [a.numpy() for a in audio],
                            "chunks": [(0.0, a.shape[0], v) for a, v in zip(audio, steps)],
                            "finished": True, "eos": False})
    served = judge.check({"records": records}, cfg, workload, seed, device)
    bad = [dict(r, frames=[np.where(np.arange(len(r["frames"][0]))[:, None] == 1,
                                    (r["frames"][0] + 1) % 2048, r["frames"][0])]) for r in records]
    altered = judge.check({"records": bad}, cfg, workload, seed, device)

    taps = taps_lib.Taps(cfg).install()
    taps.profiling = True
    try:
        core.read_packed_batch(torch.zeros(8, 8, 18, dtype=torch.int32))
    finally:
        taps.profiling = False
        taps.remove()
    window = {"cfg": cfg, "workload": workload, "trace": None, "t0": 0.0, "t1": 1.0,
              "pool_chunks": {0: {"t": 0.5, "decode_ms": 10.0, "lanes": [(8, 12, r["req"]) for r in records]}}}
    print(json.dumps({
        "served": served, "altered": altered,
        "k2": [len(taps.k2), len(mod.frame_launches(cfg, 8)) * 8, len(qwen3_tts.frame_launches(cfg, 8)) * 8],
        "k2_bytes": [sum(taps.mod.k2_bytes(*x) for x in taps.k2)],
        "step_mfu": [readers.step_mfu(window)] + [
            100.0 * 2 * 8 * m.frame_flops(cfg, 10 + 12 + 4) / 10e-3 / 989e12  # young lanes: no window vocode
            for m in (mod, qwen3_tts)]}))
""")


def test_a_configuration_with_a_model_module_of_its_own_needs_no_edit(tmp_path):
    """A toy mixture-of-experts talker (4 experts, softmax top-2, a gated
    shared expert) added to a copy as a configuration file, a model module,
    a cell and their entries: the harness resolves it, the judge draws its
    tree and holds its own greedy frames correct and an altered frame not,
    the taps count its frame's launches and the readers its operations."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    shutil.copy(pb / "tests" / "toy_moe.py", pb / "models" / "toy_moe.py")
    cfg = tiny.tiny_cfg("base")
    cfg["model"] = "toy_moe"
    cfg["talker"].update(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64,
                         shared_expert_intermediate_size=128)
    (pb / "configs" / "toy-moe.json").write_text(json.dumps(cfg))
    wl = json.loads((pb / "workloads" / "tts06b.xvec.open_cb8.json").read_text())
    wl.update(name="toy.cell", config="toy-moe", traffic="toy_mix")
    wl["traffic_params"].update(median_frames=6, min_frames=5, max_frames=7)
    (pb / "workloads" / "toy.cell.json").write_text(json.dumps(wl))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-moe", "source": "https://example.org/toy", "file":
                             "portbench/configs/toy-moe.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.cell", "config": "toy-moe", "traffic": "toy_mix", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", TOY, str(tmp_path), str(SEED), str(ROOT)], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["served"]["correct"] and r["served"]["judged"] == 2, r["served"]
    assert r["served"]["numbers"]["talker_gap"]["value"] < 1e-4
    assert r["served"]["numbers"]["audio_err"]["value"] == 0.0
    assert not r["altered"]["correct"]
    k2, want, dense = r["k2"]
    assert k2 == want != dense
    mfu, want, dense = r["step_mfu"]
    assert mfu == pytest.approx(want) and mfu != pytest.approx(dense)
    files = {p.relative_to(tmp_path) for p in tmp_path.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    added = {str(p) for p in files if not (ROOT / p).exists()}
    assert added == {"portbench/models/toy_moe.py", "portbench/configs/toy-moe.json",
                     "portbench/workloads/toy.cell.json"}
    edited = {str(p) for p in files
              if (ROOT / p).exists() and (ROOT / p).read_bytes() != (tmp_path / p).read_bytes()}
    assert edited == {"BENCHMARK.json"}, "no file of the benchmark but its list of entries was edited"
