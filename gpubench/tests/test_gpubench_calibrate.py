"""The calibration tool end to end on the CPU at the rehearsal size: one
seed with its control and a fault, every number written."""

import json

from gpubench import calibrate


def test_calibrate_writes_every_reading(tmp_path):
    out = tmp_path / "cal.json"
    assert calibrate.main(["--workload", "s3d.infonce.resident", "--seeds",
                           str(2 ** 31 + 3), "--control", "1", "--faults",
                           "half_batch", "--device", "cpu", "--shrink",
                           "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [r["side"] for r in rows] == ["program", "control", "half_batch"]
    assert rows[0]["loader"] == 0.0 and rows[0]["pool_bwd"] == 0.0
    assert rows[2]["stem"] > 10 * rows[0]["stem"] + 0.1
