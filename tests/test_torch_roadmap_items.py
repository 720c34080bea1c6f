"""The port has no module left to port: ``arnoldi_tpu_torch`` raises no
"not ported" error (no ``_not_ported(`` call, no reference to a ROADMAP.md
Queue 1 item), and ROADMAP.md's Queue 1 lists no item and says that no
module is left."""

import re
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _queue1():
    text = (REPO / "ROADMAP.md").read_text()
    start = text.index("### Queue 1")
    return text[start:text.index("\n### ", start + 1)]


def test_not_ported_errors_name_existing_items():
    # Every "not ported" error once named a Queue 1 item; the last went
    # with the filtered drivers' mesh=, so none may be left.
    for path in sorted((REPO / "arnoldi_tpu_torch").rglob("*.py")):
        source = path.read_text()
        assert "_not_ported(" not in source, f"{path.name}: a _not_ported call"
        assert not re.search(r"Queue 1 item \d", source), \
            f"{path.name}: a reference to a Queue 1 item"


def test_queue1_has_no_module_left():
    section = _queue1()
    assert not re.search(r"^\d+\. ", section, re.MULTILINE), \
        "ROADMAP.md Queue 1 still lists an item"
    assert "no module is left" in section.lower()
