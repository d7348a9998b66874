"""TEDS — Tree-Edit-Distance-based Similarity for table recognition (port
of `advancedliteratemachinery_tpu/eval/teds.py`).

Parity target: the IBM TEDS metric as vendored by CC-OCR
(reference Benchmarks/CC-OCR/evaluation/evaluator/doc_parsing_evaluator.py:
51 TableTree, :80 CustomConfig [rename cost = tag/span mismatch → 1, td
content → normalized edit distance], :101 TEDS [tokenize cells, similarity
= 1 - TED / max(n_nodes)], extract_and_clean_tables :25) and OmniParser's
table metrics (S-TEDS = structure_only).

The JAX package parses with `lxml.html.fromstring`, libxml2's HTML parser;
the card's machine has no lxml. `_parse_html_table` builds libxml2's tree
(2.14: an HTML5 tokenizer under libxml2's own tree construction) on the
stdlib `html.parser`: tag and attribute names lowercased, character
references decoded, comments, doctypes and processing instructions
dropped, carriage returns folded to newlines, every text node kept
(whitespace too); a start tag closes the open element on top of the stack
while libxml2's table (`_START_CLOSES`) says the new tag closes it, and an
end tag closes up to its element unless an element of higher end
priority lies between (`_END_PRIORITY`; an end tag of an element not
open is dropped); no `tbody` is inserted; void elements hold nothing;
script, style, xmp, iframe, noembed and noframes hold raw text, textarea
and title text with references decoded. The first `<table>` in document
order is the one scored, a cell's content all text below it; empty and
table-less input give None.
"""

from __future__ import annotations

import html.parser
import re
from typing import List, Optional

from advancedliteratemachinery_tpu_torch.eval.str_metrics import (
    edit_distance)
from advancedliteratemachinery_tpu_torch.eval.tree_edit import (
    Node, tree_edit_distance, tree_size)

# new start tag → the open elements it closes when they are on top of the
# stack (libxml2's htmlStartClose, as libxml2 2.14.6 applies it)
_START_CLOSES = {
    "a": {"a"}, "address": {"p", "ul"}, "blockquote": {"p"},
    "caption": {"p"}, "center": {"b", "font", "i", "p"},
    "col": {"caption", "col", "p"},
    "colgroup": {"caption", "colgroup", "p"},
    "dd": {"address", "dir", "dt", "listing", "menu", "p", "pre"},
    "dir": {"p"}, "div": {"p"},
    "dl": {"address", "dir", "dt", "listing", "menu", "p", "pre"},
    "dt": {"address", "dd", "dir", "listing", "menu", "p", "pre"},
    "fieldset": {"a", "h1", "h2", "h3", "h4", "h5", "h6", "legend",
                 "listing", "p", "pre"},
    "form": {"address", "dir", "dl", "form", "h1", "h2", "h3", "h4", "h5",
             "h6", "listing", "menu", "ol", "p", "pre", "ul"},
    "h1": {"p"}, "h2": {"p"}, "h3": {"p"}, "h4": {"p"}, "h5": {"p"},
    "h6": {"p"}, "hr": {"p"},
    "li": {"address", "dl", "h1", "h2", "h3", "h4", "h5", "h6", "li",
           "listing", "p", "pre"},
    "listing": {"p"}, "menu": {"p", "ul"}, "ol": {"p"},
    "optgroup": {"option"}, "option": {"option"},
    "p": {"b", "big", "h1", "h2", "h3", "h4", "h5", "h6", "i", "p", "s",
          "small", "strike", "tt", "u"},
    "pre": {"p", "ul"},
    "table": {"a", "h1", "h2", "h3", "h4", "h5", "h6", "listing", "p",
              "pre"},
    "tbody": {"caption", "colgroup", "p", "tbody", "td", "tfoot", "th",
              "thead", "tr"},
    "td": {"a", "b", "font", "i", "p", "span", "td", "th", "u"},
    "tfoot": {"caption", "colgroup", "p", "tbody", "td", "th", "thead",
              "tr"},
    "th": {"a", "b", "font", "i", "p", "span", "td", "th", "u"},
    "thead": {"caption", "colgroup"}, "title": {"p"},
    "tr": {"caption", "colgroup", "p", "td", "th", "tr"},
    "ul": {"address", "dir", "listing", "menu", "p", "pre"},
    "xmp": {"p"},
}
# an end tag closes the elements above its own only while none has a
# higher priority (libxml2's htmlEndPriority; others 100)
_END_PRIORITY = {"div": 150, "td": 160, "th": 160, "tr": 170, "thead": 180,
                 "tbody": 180, "tfoot": 180, "table": 190, "head": 200,
                 "body": 200, "html": 220}
_VOID = {"area", "base", "basefont", "br", "col", "embed", "frame", "hr",
         "img", "input", "isindex", "keygen", "link", "meta", "param",
         "source", "track", "wbr"}
# tags whose start leaves an open head open, and those that imply a head
_STAY_IN_HEAD = {"applet", "area", "base", "basefont", "caption", "col",
                 "colgroup", "embed", "head", "html", "input", "label",
                 "link", "meta", "noframes", "noscript", "object", "option",
                 "param", "script", "select", "style", "tbody", "td",
                 "textarea", "tfoot", "th", "thead", "title", "tr"}
_HEAD_IMPLIERS = {"script", "style", "meta", "link", "title", "base"}
_RAW = {"script", "style", "xmp", "iframe", "noembed", "noframes"}
_ESCAPABLE_RAW = {"textarea", "title"}
# lxml refuses a str that declares an encoding
_XML_ENCODING = re.compile(
    r'^(<\?xml[^>]+)\s+encoding\s*=\s*["\'][^"\']*["\'](\s*\?>|)', re.U)


class _Element:
    __slots__ = ("tag", "attrs", "children")

    def __init__(self, tag: str, attrs):
        self.tag = tag
        self.attrs = {}
        for k, v in attrs:                       # the first of a name wins
            self.attrs.setdefault(k, v)
        self.children: list = []                 # _Element or str

    def text_content(self) -> str:
        return "".join(c if isinstance(c, str) else c.text_content()
                       for c in self.children)

    def first(self, tag: str) -> Optional["_Element"]:
        for c in self.children:
            if isinstance(c, _Element):
                if c.tag == tag:
                    return c
                found = c.first(tag)
                if found is not None:
                    return found
        return None


class _LibxmlTree(html.parser.HTMLParser):
    """libxml2's HTML tree construction over `html.parser`'s tokens: the
    implied html, head and body, the start tags that close the open
    element (`_START_CLOSES`; an open head closes before any tag but those
    of `_STAY_IN_HEAD`), the end tags' priorities, and the misplaced html,
    head and body start tags, which are dropped and make the next html,
    head or body end tag drop too (libxml2's `depth`)."""

    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.root = _Element("#document", ())
        self.stack: List[_Element] = []
        self.level = 0          # libxml2's ctxt->html: 3 head seen, 10 body
        self.depth = 0

    def _push(self, el: _Element) -> None:
        (self.stack[-1] if self.stack else self.root).children.append(el)
        self.stack.append(el)
        if el.tag == "head":
            self.level = max(self.level, 3)
        elif el.tag == "body":
            self.level = 10

    def _implied(self, tag: str) -> None:
        if tag == "html":
            return
        if not self.stack:
            self._push(_Element("html", ()))
        if tag in ("body", "head"):
            return
        if len(self.stack) <= 1 and tag in _HEAD_IMPLIERS:
            if self.level < 3:
                self._push(_Element("head", ()))
        elif tag not in ("noframes", "frame", "frameset") \
                and self.level < 10 \
                and not any(el.tag in ("body", "head") for el in self.stack):
            self._push(_Element("body", ()))

    def _start(self, tag, attrs, self_closing: bool) -> None:
        closes = _START_CLOSES.get(tag, ())
        while self.stack and (self.stack[-1].tag in closes or (
                self.stack[-1].tag == "head" and tag not in _STAY_IN_HEAD)):
            self.stack.pop()
        self._implied(tag)
        dropped = ((tag == "html" and self.stack)
                   or (tag == "head" and len(self.stack) != 1)
                   or (tag == "body" and any(el.tag == "body"
                                             for el in self.stack)))
        if dropped:
            self.depth += 1
            if self_closing:             # its "/>" still closes the top
                self.stack.pop()
            return
        el = _Element(tag, attrs)
        if tag in _VOID:
            (self.stack[-1] if self.stack else self.root).children.append(el)
            return
        self._push(el)
        if self_closing:
            self.stack.pop()
        elif tag in _RAW or tag in _ESCAPABLE_RAW:
            self.set_cdata_mode(tag, escapable=tag in _ESCAPABLE_RAW)

    def handle_starttag(self, tag, attrs):
        self._start(tag, attrs, False)

    def handle_startendtag(self, tag, attrs):
        self._start(tag, attrs, True)

    def handle_endtag(self, tag):
        if self.depth > 0 and tag in ("html", "body", "head"):
            self.depth -= 1
            return
        names = [el.tag for el in self.stack]
        if tag not in names:
            return
        priority = _END_PRIORITY.get(tag, 100)
        for name in reversed(names):
            if name == tag:
                break
            if _END_PRIORITY.get(name, 100) > priority:
                return
        while self.stack[-1].tag != tag:
            self.stack.pop()
        self.stack.pop()

    def handle_data(self, data):
        if not self.stack or self.stack[-1].tag in ("html", "head"):
            if not data.strip(" \t\n\f\r"):
                return                   # libxml2's ignorable blanks
            if self.stack and self.stack[-1].tag == "head":
                self.stack.pop()
            self._implied("#text")
        self.stack[-1].children.append(data)


def _parse_html_table(html_text: str) -> Optional[Node]:
    """HTML → TableTree (tags kept: table/thead/tbody/tr/td/th and any
    other element; td carries colspan/rowspan + its characters), the
    first table of the document, as the JAX function reads it through
    lxml; None without one."""
    if _XML_ENCODING.match(html_text):
        return None
    parser = _LibxmlTree()
    parser.feed(html_text.replace("\r\n", "\n").replace("\r", "\n"))
    parser.close()
    table = parser.root.first("table")
    if table is None:
        return None

    def convert(el: _Element) -> Node:
        tag = "td" if el.tag == "th" else el.tag
        node = Node(tag)
        if tag == "td":
            node.colspan = int(el.attrs.get("colspan", 1) or 1)
            node.rowspan = int(el.attrs.get("rowspan", 1) or 1)
            node.content = list(el.text_content())
        else:
            node.children = [convert(c) for c in el.children
                             if isinstance(c, _Element)]
        return node

    return convert(table)


def extract_and_clean_tables(text: str) -> str:
    """Pull <table>...</table> blocks out of an LMM response and flatten
    whitespace (doc_parsing_evaluator.py:25)."""
    tables = re.findall(r"<table.*?>.*?</table>", text, flags=re.DOTALL | re.IGNORECASE)
    clean = []
    for t in tables:
        t = re.sub(r">(.*?)<",
                   lambda m: ">" + m.group(1).replace("\n", "").replace(" ", "") + "<",
                   t, flags=re.DOTALL)
        clean.append(t.replace("\n", "").strip())
    return "".join(clean)


class TEDS:
    def __init__(self, structure_only: bool = False):
        self.structure_only = structure_only

    def _rename(self, a: Node, b: Node) -> float:
        if a.label != b.label or a.colspan != b.colspan or a.rowspan != b.rowspan:
            return 1.0
        if a.label == "td" and not self.structure_only:
            ca = a.content or []
            cb = b.content or []
            if ca or cb:
                return edit_distance("".join(ca), "".join(cb)) / max(
                    len(ca), len(cb))
        return 0.0

    def evaluate(self, pred_html: str, gt_html: str) -> float:
        """→ similarity in [0, 1] (doc_parsing_evaluator.py TEDS.evaluate)."""
        pred = _parse_html_table(pred_html)
        gt = _parse_html_table(gt_html)
        if gt is None:
            return 0.0
        if pred is None:
            return 0.0
        if self.structure_only:
            _strip_content(pred)
            _strip_content(gt)
        dist = tree_edit_distance(pred, gt, rename=self._rename)
        n = max(tree_size(pred), tree_size(gt))
        return 1.0 - dist / max(n, 1)


def _strip_content(node: Node) -> None:
    node.content = []
    for c in node.children:
        _strip_content(c)
