"""The architecture server (``--mode lm --lm-legacy``) on the CPU: each
family's ``--smoke`` config served with and without ``--kv8`` / ``--w8``,
its sample continuation equal to a direct prefill/decode loop of the port
on the same seeded weights and prompts, and the launcher's usage errors.
"""
import re

import pytest
import torch

from repro_torch.launch import serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.nn.dims import compute_dims

ARCHS = ("tinyllama-1.1b", "llama4-scout-17b-a16e", "mamba2-780m",
         "zamba2-1.2b", "musicgen-large")
CMD = ["--mode", "lm", "--lm-legacy", "--smoke", "--device", "cpu",
       "--batch", "2", "--prompt-len", "12", "--tokens", "5"]


def _sample(out: str) -> list:
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith("[lm] sample continuation:")]
    return [int(t) for t in re.findall(r"-?\d+", line.split(":", 1)[1])]


def _direct_loop(argv) -> list:
    """The same weights and prompts through the steps, one call each."""
    args = serve.parser().parse_args(argv)
    cfg = serve.lm_arch_config(args)
    dims = compute_dims(cfg)
    params = serve.lm_arch_params(cfg, dims, torch.device("cpu"), w8=args.w8)
    gen = torch.Generator().manual_seed(7)
    batch = serve.lm_prompts(cfg, dims, args.batch, args.prompt_len, gen,
                             "cpu")
    s = args.prompt_len
    logits, cache = make_prefill_step(cfg, dims, s_max=s + args.tokens)(
        params, batch)
    decode = make_decode_step(cfg, dims)
    toks = [int(torch.argmax(logits[0]))]
    nxt = torch.argmax(logits, -1)[:, None]
    for i in range(args.tokens):
        inp = nxt if cfg.frontend == "text" else serve.lm_prompts(
            cfg, dims, args.batch, 1, gen, "cpu")["embeds"]
        logits, cache = decode(params, cache, inp, s + i)
        nxt = torch.argmax(logits, -1)[:, None]
        toks.append(int(nxt[0, 0]))
    return toks


@pytest.mark.parametrize("flags", [[], ["--kv8"], ["--w8"]],
                         ids=["bf16", "kv8", "w8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_server_serves_each_family(arch, flags, capsys):
    argv = CMD + ["--arch", arch] + flags
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "[lm] prefill 2x12:" in out and "[lm] decode 5 steps:" in out
    got = _sample(out)
    assert len(got) == 6 and all(0 <= t < 256 for t in got)
    assert got == _direct_loop(argv)


def test_kv8_and_w8_change_what_is_served():
    """--kv8 stores int8 K/V for the archs that attend (the SSM has no KV
    cache); --w8 serves dequantized int8 weights."""
    base = ["--mode", "lm", "--lm-legacy", "--smoke"]
    for arch, attends in (("tinyllama-1.1b", True), ("mamba2-780m", False)):
        args = serve.parser().parse_args(base + ["--arch", arch, "--kv8"])
        assert serve.lm_arch_config(args).kv_quant is attends
    args = serve.parser().parse_args(base + ["--w8"])
    cfg = serve.lm_arch_config(args)
    dims = compute_dims(cfg)
    cpu = torch.device("cpu")
    w = serve.lm_arch_params(cfg, dims, cpu)["groups"]["mlp"]["w_up"]
    w8 = serve.lm_arch_params(cfg, dims, cpu, w8=True)["groups"]["mlp"]["w_up"]
    assert w8.dtype == torch.bfloat16 and not torch.equal(w, w8)
    assert len(torch.unique(w8.float())) <= 255


def test_arch_server_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--mode", "lm", "--lm-legacy", "--smoke"])


@pytest.mark.parametrize("argv", [
    ["--arch", "zamba2-1.2b"], ["--mode", "lm", "--kv8"],
    ["--mode", "lm", "--w8", "--lm-compiled"], ["--smoke"],
    ["--mode", "space", "--lm-legacy"]])
def test_arch_flags_outside_the_arch_server_are_usage_errors(argv):
    with pytest.raises(SystemExit) as e:
        serve.main(argv)
    assert "--lm-legacy" in str(e.value)


def test_unknown_arch_is_refused():
    with pytest.raises(KeyError, match="unknown arch"):
        serve.main(CMD + ["--arch", "gpt-17"])
