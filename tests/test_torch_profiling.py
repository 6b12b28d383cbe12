"""``utils.profiling`` of the port against the JAX package's: the
``OpProfiler`` counts and times every call made through it, passes
attributes through, and reports in the JAX package's format (the same
report and ``as_dict`` for the same times); ``torch_trace`` writes a trace."""

import os

import numpy as np
import torch

from lattigo_tpu.utils.profiling import OpProfiler as JaxOpProfiler
from lattigo_tpu_torch.models import bfv
from lattigo_tpu_torch.utils.profiling import OpProfiler, _first_tensor, torch_trace

torch.set_num_threads(1)

SMALL = dict(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60))


def _setup():
    params = bfv.Parameters(**SMALL).gen_from_log_moduli()
    kg = bfv.KeyGenerator(params, device="cpu", seed=1)
    sk, pk = kg.gen_key_pair()
    enc = bfv.Encoder(params, device="cpu")
    ct = bfv.Encryptor(params, pk=pk, device="cpu").encrypt(
        enc.encode_uint(np.arange(params.n, dtype=np.uint64)))
    return params, kg.gen_relin_key(sk), ct


def test_op_profiler_counts_and_times_calls():
    params, rlk, ct = _setup()
    ev = OpProfiler(bfv.Evaluator(params, device="cpu"))
    for _ in range(2):
        out = ev.relinearize(ev.mul(ct, ct), rlk)
    ev.add(out, out)
    assert dict(ev.calls) == {"mul": 2, "relinearize": 2, "add": 1}
    assert all(t > 0 for t in ev.times.values())
    assert ev.params is ev._ev.params  # attributes pass through
    d = ev.as_dict()
    assert d["mul"]["calls"] == 2 and d["mul"]["total_ms"] >= d["mul"]["mean_ms"] > 0
    lines = ev.report().splitlines()
    assert lines[0].split() == ["op", "calls", "total_ms", "mean_ms", "%"]
    assert sorted(line.split()[0] for line in lines[1:]) == ["add", "mul", "relinearize"]
    ev.reset()
    assert not ev.calls and not ev.times


def test_report_and_dict_match_the_jax_profiler():
    times = {"mul": 0.012345, "relinearize": 0.5, "rescale": 0.00025}
    calls = {"mul": 3, "relinearize": 2, "rescale": 7}
    ours, theirs = OpProfiler(object()), JaxOpProfiler(object())
    for p in (ours, theirs):
        p.times.update(times)
        p.calls.update(calls)
    assert ours.report() == theirs.report()
    assert ours.as_dict() == theirs.as_dict()


def test_first_tensor_finds_the_output():
    params, _, ct = _setup()
    assert _first_tensor(ct) is ct.value[0]
    assert _first_tensor(({"a": None}, [ct])) is ct.value[0]
    assert _first_tensor(3) is None


def test_torch_trace_writes_a_trace(tmp_path):
    params, rlk, ct = _setup()
    ev = bfv.Evaluator(params, device="cpu")
    with torch_trace(str(tmp_path)) as prof:
        ev.relinearize(ev.mul(ct, ct), rlk)
    assert any(e.key.startswith("aten::") for e in prof.key_averages())
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
