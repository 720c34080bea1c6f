"""Every "not ported" error of ``arnoldi_tpu_torch`` names a ROADMAP.md
Queue 1 item that exists and is about the refused feature: the first word
of the error's subject (``a complex work dtype`` -> ``complex``) appears in
that item's text."""

import re
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_ITEM = re.compile(r"Queue 1 item (\d+)")
_NOT_PORTED = re.compile(r'_not_ported\(\s*"([^"]+)"\s*,\s*"Queue 1 item (\d+)"')
_ARTICLES = ("a", "an", "the")


def _queue1_items():
    """{number: text} of ROADMAP.md's Queue 1 list."""
    text = (REPO / "ROADMAP.md").read_text()
    start = text.index("### Queue 1")
    section = text[start:text.index("\n### ", start + 1)]
    items, current = {}, None
    for line in section.splitlines():
        m = re.match(r"(\d+)\. ", line)
        if m:
            current = int(m.group(1))
            items[current] = line
        elif current is not None and line.startswith("   "):
            items[current] += " " + line.strip()
        elif line and not line.startswith(" "):
            current = None
    return items


def _subject_word(what):
    words = [w for w in what.split() if w.lower() not in _ARTICLES]
    return words[0].lower()


def test_not_ported_errors_name_existing_items():
    items = _queue1_items()
    assert items, "ROADMAP.md has no Queue 1 list"
    refs = []
    for path in sorted((REPO / "arnoldi_tpu_torch").rglob("*.py")):
        source = path.read_text()
        for what, num in _NOT_PORTED.findall(source):
            refs.append((path.name, what, int(num)))
        # any other item reference must sit in a NotImplementedError too
        for m in _ITEM.finditer(source):
            line = source[:m.start()].count("\n") + 1
            context = source[max(0, m.start() - 400):m.start()]
            assert "_not_ported(" in context or "NotImplementedError(" in \
                context, f"{path.name}:{line}: an item reference outside an error"
    assert refs, "no _not_ported() call found"
    for name, what, num in refs:
        assert num in items, f"{name}: {what!r} names Queue 1 item {num}, " \
            f"which ROADMAP.md does not have"
        word = _subject_word(what)
        assert word in items[num].lower(), \
            f"{name}: {what!r} names item {num}, which is about something " \
            f"else: {items[num][:80]!r}"
