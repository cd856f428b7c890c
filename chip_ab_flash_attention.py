#!/usr/bin/env python3
"""A/B of the port's flash-attention tensor-core kernel against another
tree's, on one GPU, and the split of its time by stage.

Times ``flash_attention`` (bfloat16, the ``wgmma`` kernel) at every
bfloat16 prefill and encode shape of the LM paths, with
``chip_smoke.py``'s ``phase_prefill_attention``: granite-3-2b (D 64,
causal and window 512), moonshot-v1-16b-a3b (D 128), MLA (D 192, v
padded), recurrentgemma-2b (MQA 10/1, D 256, window 2048, at S 2048 and
4096), paligemma-3b (MQA 8/1, D 256), hubert-xlarge (D 80,
bidirectional), internlm2-20b (48/8, D 128) and command-r-plus-104b
(96/8, D 128); once with this tree's ``repro_torch`` and once with the
baseline tree's, in the turns of ``chip_ab.py`` (baseline, this, this,
baseline, each in its own process, on the same card within one run).
Every turn holds the kernel to its plain version (bfloat16 ``2e-2`` and
the row rule) and reports the registers and spills of each instance of
the kernel from ``ptxas``.

Usage (one CUDA device), with a baseline checkout at DIR, e.g.
``git archive <commit> | tar -x -C DIR``::

    python3 chip_ab_flash_attention.py DIR            # the A/B
    python3 chip_ab_flash_attention.py --measure DIR  # one turn, DIR alone
    python3 chip_ab_flash_attention.py --diagnose DIR # DIR's stage split

Each turn prints one JSON line; the last line gathers them with the
card's name and power limit.

``--diagnose`` splits DIR's kernel time by stage. It copies DIR's
``flash_attention.cu`` into ``build/fa_diagnose/`` (never into a
package), edits each copy (``VARIANTS``: the softmax replaced by a
constant, P·V taken once, the copies alone, the copies and Q Kᵀ alone),
builds every copy with the package's ``nvcc`` flags, all at once, and
times each by graph replay at the shapes above, beside the unedited
source. It fails, building nothing, where a variant's edits do not
match DIR's source (another kernel's). It also times the unedited kernel at
hubert's shape with D 80 against D 64 and D 128 at the same bytes (Hq·D
held at 1280), which shows what padding D costs. The edited kernels'
outputs are wrong by design; only the unedited one is held to the plain
version. Its last line gathers every time with the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

import chip_ab

# (name, B, Hq, Hkv, S, D, v_dim, causal, window)
SHAPES = (
    ("granite", 4, 32, 8, 2048, 64, 64, True, 0),
    ("granite_window512", 4, 32, 8, 2048, 64, 64, True, 512),
    ("moonshot", 4, 16, 16, 2048, 128, 128, True, 0),
    ("internlm2", 4, 48, 8, 2048, 128, 128, True, 0),
    ("command_r_plus", 4, 96, 8, 2048, 128, 128, True, 0),
    ("mla", 4, 128, 128, 2048, 192, 128, True, 0),
    ("recurrentgemma", 4, 10, 1, 2048, 256, 256, True, 2048),
    ("recurrentgemma_4096", 4, 10, 1, 4096, 256, 256, True, 2048),
    ("paligemma", 4, 8, 1, 2048, 256, 256, True, 0),
    ("hubert", 4, 16, 16, 2048, 80, 80, False, 0),
)
# hubert's shape at the same bytes (Hq * D = 1280) with D 64 and D 128
SAME_BYTES = (
    ("hubert_d64_h20", 4, 20, 20, 2048, 64, 64, False, 0),
    ("hubert_d128_h10", 4, 10, 10, 2048, 128, 128, False, 0),
)
SAME_BYTES_NAMES = {shape[0] for shape in SAME_BYTES}
KEEP = ("ms", "call_ms", "max_abs_err", "max_row_rel_err", "library_ms",
        "bound_ms")
KERNEL = "flash_attention_tc_kernel"

# The stage split: edits of the tensor-core kernel's source, each a
# ("replace", old, new) or ("span", start, end, new) edit whose strings
# are code (no comment) and must match the source once.
_FN = "template <{}>\n__device__ __forceinline__ void {}("
_SOFTMAX_FN = _FN.format("int BK", "softmax_tile")
_SPLIT_FN = _FN.format("int BK", "split_p")
_LOAD_FN = _FN.format("int NP, int TAIL", "load_tile")
_PV_FN = _FN.format("int NP, int TAIL", "issue_pv")
_CONST_SOFTMAX = (
    _SOFTMAX_FN + "\n"
    "    float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],"
    "\n    bool, int, int, int, int, int, int, float) {\n#pragma unroll\n"
    "  for (int i = 0; i < BK / 2; ++i) s[i] = s[i] * 0.0f + 0.0078125f;\n"
    "  alpha[0] = alpha[1] = 1.0f;\n  m[0] = m[1] = 0.0f;\n"
    "  l[0] += 1.0f;\n  l[1] += 1.0f;\n}\n\n")
_PV_LO = ("    wgmma_rs<64 * NP>(o, pl[kk], dv + ((kk * 16 * 128) >> 4));\n",
          "      wgmma_rs<16>(ot, pl[kk], dvt + ((kk * 16 * 32) >> 4));\n")
_PV_HI = ("    wgmma_rs<64 * NP>(o, ph[kk], dv + ((kk * 16 * 128) >> 4));\n",
          "      wgmma_rs<16>(ot, ph[kk], dvt + ((kk * 16 * 32) >> 4));\n")
_S_BODY = "  const uint64_t dq = make_desc(q, 16, 1024, kSwizzle128);\n"
_NO_SPLIT = (
    _SPLIT_FN + "\n    const float (&)[BK / 2], uint32_t (&)[BK / 16][4],\n"
    "    uint32_t (&)[BK / 16][4]) {}\n\n")
VARIANTS = {
    "softmax_const": (("span", _SOFTMAX_FN, _SPLIT_FN, _CONST_SOFTMAX),),
    "pv_once": tuple(("replace", x, "") for x in _PV_LO),
    "qk_only": (("span", _SOFTMAX_FN, _SPLIT_FN, _CONST_SOFTMAX),
                *(("replace", x, "") for x in _PV_LO + _PV_HI)),
    # the tile loop with its copies and barriers, no product: the softmax
    # is a constant, P is not split and O's rescale by 1 folds away
    "copies_only": (("span", _SOFTMAX_FN, _SPLIT_FN, _CONST_SOFTMAX),
                    ("span", _SPLIT_FN, _LOAD_FN, _NO_SPLIT),
                    ("span", _S_BODY, _PV_FN, "}\n\n"),
                    *(("replace", x, "") for x in _PV_LO + _PV_HI)),
}


def instance(entry: str) -> str:
    """A kernel instance's template arguments from its mangled name."""
    tail = entry.split(KERNEL, 1)[1]
    m = re.match(r"I(.*?)E(EvT_|Ev)", tail)
    return m.group(1) if m else tail[:24]


def measure(tree: Path) -> Dict:
    """One turn: ``tree``'s ``repro_torch`` on the card."""
    import chip_smoke
    sys.path.insert(0, str(tree / "src"))    # ahead of chip_smoke's own
    import torch
    import repro_torch
    from repro_torch.kernels.flash_attention import kernel as fa
    chip_smoke.gate(Path(repro_torch.__file__).resolve().is_relative_to(
        tree.resolve()), f"repro_torch did not come from {tree}")
    dev = torch.device("cuda", 0)
    report = chip_ab.nvcc_report(fa.SOURCE)
    out = {"tree": str(tree),
           "ptxas": {instance(name): v for name, v in
                     chip_smoke.ptxas_entries(report, KERNEL).items()},
           "ptxas_warnings": _warnings(report)}
    for name, b, hq, hkv, s, d, v_dim, causal, window in SHAPES:
        res = chip_smoke.phase_prefill_attention(
            dev, name, b, hq, s, d, v_dim, seed=40, reps=10, hkv=hkv,
            causal=causal, window=window)
        out[name] = {k: res[k] for k in KEEP}
        chip_smoke._free(dev)
    return out


def _warnings(report: str):
    """ptxas's warnings (a serialised ``wgmma`` pipeline shows here)."""
    return sorted({line.strip() for line in report.splitlines()
                   if "warning" in line.lower()})


def _edit(text: str, edits) -> str:
    """``text`` with ``edits`` applied; raises ValueError where one does
    not match exactly once."""
    for edit in edits:
        if edit[0] == "replace":
            _, old, new = edit
            if text.count(old) != 1:
                raise ValueError(f"{old!r} is not in the source once")
            text = text.replace(old, new)
        else:
            _, start, end, new = edit
            for anchor in (start, end):
                if text.count(anchor) != 1:
                    raise ValueError(f"{anchor!r} is not in the source once")
            i, j = text.index(start), text.index(end)
            if j < i:
                raise ValueError(f"{end!r} comes before {start!r}")
            text = text[:i] + new + text[j:]
    return text


def variant_sources(src: str) -> Dict[str, str]:
    """``src`` unedited (``"full"``) and each variant of it; raises
    ValueError, naming the variant, where an edit does not match."""
    out = {"full": src}
    for name, edits in VARIANTS.items():
        try:
            out[name] = _edit(src, edits)
        except ValueError as err:
            raise ValueError(f"variant {name}: {err}") from None
    return out


def _build_variant(name: str, text: str, out_dir: Path, bind
                   ) -> Tuple[ctypes.CDLL, str]:
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    lib = out_dir / f"lib{name}.so"
    report = chip_ab.nvcc_report(src, lib)
    cdll = ctypes.CDLL(str(lib))
    bind(cdll)
    return cdll, report


def _launcher(lib, q, k, v, out, causal: bool, window: int, scale: float):
    """One launch of ``lib``'s tensor-core kernel on the current stream,
    with the wrapper's arguments."""
    import torch
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]

    def run():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b,
            hq, hkv, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], ctypes.c_float(scale),
            int(causal), int(window), 1, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return run


def diagnose(tree: Path) -> Dict:
    """``tree``'s kernel and its edited copies, timed at every shape."""
    import chip_smoke
    sys.path.insert(0, str(tree / "src"))
    import torch
    import torch.nn.functional as F
    import repro_torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    chip_smoke.gate(Path(repro_torch.__file__).resolve().is_relative_to(
        tree), f"repro_torch did not come from {tree}")
    dev = torch.device("cuda", 0)
    src = fa.SOURCE.read_text()
    out_dir = Path(__file__).resolve().parent / "build" / "fa_diagnose"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = variant_sources(src)
    with ThreadPoolExecutor(len(texts)) as ex:
        libs = dict(zip(texts, ex.map(
            lambda n: _build_variant(n, texts[n], out_dir, fa._bind),
            texts)))
    out: Dict = {"tree": str(tree),
                 "ptxas": {n: {instance(e): r for e, r in
                               chip_smoke.ptxas_entries(rep, KERNEL).items()}
                           for n, (_, rep) in libs.items()},
                 "ptxas_warnings": {n: _warnings(rep)
                                    for n, (_, rep) in libs.items()}}
    for i, (name, b, hq, hkv, s, d, v_dim, causal, window) in enumerate(
            SHAPES + SAME_BYTES):
        g = chip_smoke._generator(dev, 40 + i)
        q, k, v = chip_smoke._randn(g, dev, torch.bfloat16, (b, hq, s, d),
                                    (b, hkv, s, d), (b, hkv, s, v_dim))
        v = F.pad(v, (0, d - v_dim))
        scale = float(d) ** -0.5
        o = torch.empty((b, s, hq, d), dtype=q.dtype,
                        device=dev).transpose(1, 2)
        res: Dict = {}
        names = ("full",) if name in SAME_BYTES_NAMES else tuple(libs)
        for n in names:
            run = _launcher(libs[n][0], q, k, v, o, causal, window, scale)
            if n == "full":
                run()
                chip_smoke.sync(dev)
                res.update(chip_smoke._check_close(
                    f"{name} full", o, flash_attention_ref(
                        q, k, v, causal=causal, window=window,
                        scale=scale)))
            res[f"{n}_ms"] = chip_smoke.graph_ms(run, dev, 10)
        pairs = b * hq * chip_smoke._attn_pairs(s, s, causal, window)
        res["pairs"] = pairs
        res["bound_ms"] = chip_smoke.bound(
            2 * (2 * q.numel() + k.numel() + v.numel()), 4 * d * pairs,
            chip_smoke.H100_BF16_OPS_PER_S)["bound_ms"]
        out[name] = res
        del q, k, v, o
        chip_smoke._free(dev)
    return out


def _diagnose_main(tree: str) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_ab_flash_attention: no CUDA device", file=sys.stderr)
        return 1
    res = diagnose(Path(tree).resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, **res}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--diagnose":
        sys.exit(_diagnose_main(sys.argv[2]))
    sys.exit(chip_ab.main(__file__, __doc__, measure))
