"""The port's RD report and trajectory (ssgvc_tpu_torch/experiments/
rd_report.py, rd_trajectory.py) against the JAX scripts
(experiments/rd_report.py, rd_trajectory.py, imported by path) on the same
inputs.

The JAX report runs with its module's REPO pointed at the test's temporary
directory, so it reads the artifacts copied there and writes its
RESULTS.md there, never the committed one. The port reads the same files
under artifacts/torch/ of its working directory. Each section the port
keeps renders the JAX section's text: the same heading, the same table
rows and the same result lines, with the port's paths (artifacts/torch/,
figures beside its RESULTS.md) and its provenance (the H100 where the JAX
report names the TPU or a CPU host) in place of the JAX report's.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

from ssgvc_tpu_torch.experiments import rd_report, rd_trajectory

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "experiments"))

import rd_report as jax_report  # noqa: E402
import rd_trajectory as jax_trajectory  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: F401

LOG = """\
=== marathon start 2026-01-01T00:00 (recipe a) ===
[performance+] bpp=[0.11, 0.2, 0.31, 0.45, 0.7]
[performance+] psnr=[25.1, 26.4, 27.5, 28.2, 28.9]
[performance+] roi=[24.0, 25.5, 26.9, 27.8, 28.5]
=== continue cycle 1 done 2026-01-01T01:00 rc=0
=== marathon start 2026-01-02T00:00 (recipe b) ===
[performance+] bpp=[0.1, 0.19, 0.3, 0.44, 0.69]
[performance+] psnr=[25.3, 26.6, 27.7, 28.4, 29.1]
[performance+] roi=[24.4, 25.9, 27.2, 28.1, 28.8]
[plain+] bpp=[0.12, 0.21, 0.33, 0.47, 0.72]
[plain+] psnr=[25.2, 26.5, 27.6, 28.3, 29.0]
[plain+] roi=[23.9, 25.2, 26.5, 27.4, 28.1]
=== continue cycle 1 done 2026-01-02T01:00 rc=0
[performance+] bpp=[0.1, 0.18, 0.29, 0.43, 0.68]
[performance+] psnr=[25.5, 26.8, 27.9, 28.6, 29.3]
[performance+] roi=[24.7, 26.1, 27.5, 28.4, 29.1]
=== continue cycle 2 done 2026-01-02T02:00 rc=1
[plain+] psnr=[25.4, 26.7, 27.8, 28.5, 29.2]
"""


def test_trajectory_parse_and_summary_equal_jax(tmp_path, monkeypatch):
    """parse / summarize on the same log text (two marathon epochs, a
    failed cycle, a cycle stopped mid-run) equal the JAX script's; main
    writes them under artifacts/torch/."""
    log = tmp_path / "rd_marathon.log"
    log.write_text(LOG)
    cycles = rd_trajectory.parse(str(log))
    assert cycles == jax_trajectory.parse(str(log))
    assert [c["cycle"] for c in cycles] == [1, 2, 3]
    assert cycles[-1]["partial"]
    assert rd_trajectory.summarize(cycles) == \
        jax_trajectory.summarize(cycles)
    monkeypatch.chdir(tmp_path)
    out = rd_trajectory.main([str(log)])
    stored = json.loads((tmp_path / "artifacts/torch/rd_trajectory.json")
                        .read_text())
    assert stored == json.loads(json.dumps(out))
    assert set(stored) == {"source", "note", "cycles", "summary"}
    assert stored["summary"] == jax_trajectory.summarize(cycles)


def _sections(text):
    """{heading: lines} of each '## ' section."""
    out, name = {}, None
    for line in text.splitlines():
        if line.startswith("## "):
            name = line
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


#: the port's wording where it names its own paths and provenance
PORT_WORDS = (("artifacts/torch/", "artifacts/"),
              ("](rd_", "](artifacts/rd_"),
              ("→ checkpoint file → restored",
               "→ orbax checkpoint → restored"),
              ("s, H100)", "s, CPU)"),
              ("here it is shown", "on this 1-CPU-core host it is shown"))


def _as_jax(line):
    for port, jax in PORT_WORDS:
        line = line.replace(port, jax)
    return line


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Both reports on the committed JAX artifacts (the trajectory and the
    e2e journey's record among them): (port text, JAX text, artifacts the
    port read)."""
    tmp = tmp_path_factory.mktemp("report")
    (tmp / "artifacts" / "torch").mkdir(parents=True)
    for f in sorted((ROOT / "artifacts").glob("*.json")):
        for d in (tmp / "artifacts", tmp / "artifacts" / "torch"):
            shutil.copy(f, d / f.name)
    # the TPU records the JAX report renders and the port's does not
    for f in sorted(ROOT.glob("BENCH_r*.json")) + sorted(
            ROOT.glob("MULTICHIP_r*.json")):
        shutil.copy(f, tmp / f.name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_report, "REPO", str(tmp))
        jax_report.main()
        mp.chdir(tmp)
        dest = rd_report.main([])
        _, found = rd_report.report()
    jax_text = (tmp / "RESULTS.md").read_text()
    port_text = (tmp / dest).read_text()
    return port_text, jax_text, found


def test_report_writes_under_artifacts_torch(reports):
    port, jax_text, found = reports
    assert (ROOT / "RESULTS.md").read_text() != port
    assert port.startswith("# Results (PyTorch port)")
    assert "TPU" not in port
    assert "throughput comes from the port's benchmark" in port
    for p in found:
        assert p.startswith("artifacts/torch/") and f"`{p}`" in port
    # the sections that render TPU records are the JAX report's alone
    for gone in ("1080p throughput", "W8A8 int8 A/B", "bench battery",
                 "Host rANS coder", "Multi-chip dryrun"):
        assert gone in jax_text and gone not in port


KEPT = ("## RD curves", "## Extended 192px polish",
        "## ROI-subset masks", "## Full seg-guidance package",
        "## mask_prop's trade", "## Scale-up: rd-half",
        "## RD trajectory", "## Fresh-data keep-best",
        "## Checkpoint re-evaluation", "## End-to-end Waymo-format")


@pytest.mark.parametrize("heading", KEPT)
def test_kept_section_renders_the_jax_text(heading, reports):
    """The section under ``heading``: present in both reports, the same
    heading, every table row and every result line (a line with a bold
    number) of the JAX section in the port's, and every line of the
    port's in (or part of a line of) the JAX section, in the port's
    wording for paths and provenance; the lines the port leaves out are
    the JAX report's TPU history."""
    port, jax_text, _ = reports
    ps, js = _sections(port), _sections(jax_text)
    (pname,) = [k for k in ps if k.startswith(heading)]
    (jname,) = [k for k in js if k.startswith(heading)]
    assert _as_jax(pname) == jname
    plines = [_as_jax(x) for x in ps[pname] if x]
    jlines = [x for x in js[jname] if x]
    for line in jlines:
        if line.startswith("|") or line.startswith("###") or "**" in line:
            assert line in plines, line
    trained = "trained on the "
    for line in plines:
        if trained in line:
            # the provenance of the RD curves
            assert "H100" in line or "CPU" in line
            head = line.split(trained)[0]
            assert any(j.startswith(head) for j in jlines), line
        elif line.startswith("(No figure drawn"):
            assert any(j.startswith("![") for j in jlines)
        else:
            # a JAX line, or part of one the port shortened
            assert any(line in j for j in jlines), line
