"""Regex -> NFA transpiler (the RegexParser analog).

The port's copy of the JAX package's `ops/regex_nfa.py`, which is plain
Python and numpy: the port keeps its own copy rather than import it.
The reference transpiles Java regexes to cuDF's regex kernel dialect
(reference: RegexParser.scala:47, CudfRegexTranspiler:696, 2,137 LoC);
this module compiles a Java-regex SUBSET straight to data: a Thompson
NFA with <= 32 states represented as bitmasks plus a 256-entry
byte->equivalence-class table, executed as a vectorized bit-parallel
simulation (ops/regex_exec.py): O(bytes x states) tensor work, no
per-row control flow.

Supported subset (byte-domain, ASCII patterns):
  literals, escaped metachars, `.` (any byte except \\n), char classes
  [a-z0-9_], [^...], \\d \\w \\s \\D \\W \\S (in and out of classes),
  quantifiers * + ? {m} {m,n} {m,} (greedy), alternation |, groups
  ( ) (?: ), anchors ^ $.
Rejected (raises RegexUnsupported -> planner tags/falls back): lazy
quantifiers, backreferences, lookaround, \\b, unicode classes, patterns
needing > 32 NFA states.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Set, Tuple

import numpy as np

__all__ = ["RegexUnsupported", "RegexSyntaxError", "parse", "compile_nfa",
           "CompiledRegex"]

MAX_STATES = 32


class RegexUnsupported(Exception):
    """Valid Java pattern outside the transpilable subset — eligible for
    the host CPU fallback."""


class RegexSyntaxError(ValueError):
    """Pattern Java itself would reject (PatternSyntaxException analog):
    a hard user error, NOT eligible for fallback — Python `re` may parse
    some of these as literals and silently change answers."""


# ---------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------
@dataclasses.dataclass
class Lit:
    byte: int


@dataclasses.dataclass
class Klass:
    bytes_in: frozenset          # set of matching byte values


@dataclasses.dataclass
class Concat:
    parts: list


@dataclasses.dataclass
class Alt:
    options: list


@dataclasses.dataclass
class Repeat:
    child: object
    lo: int
    hi: Optional[int]            # None = unbounded


@dataclasses.dataclass
class Group:
    child: object
    index: int                   # 0 = non-capturing


ANY_NO_NL = frozenset(range(256)) - {10}
_D = frozenset(range(48, 58))
_W = _D | frozenset(range(65, 91)) | frozenset(range(97, 123)) | {95}
_S = frozenset([32, 9, 10, 11, 12, 13])


class _Parser:
    def __init__(self, pat: str):
        try:
            self.b = pat.encode("ascii")
        except UnicodeEncodeError:
            raise RegexUnsupported("non-ASCII pattern")
        self.i = 0
        self.ngroups = 0
        self.anchored_start = False
        self.anchored_end = False

    def peek(self):
        return self.b[self.i] if self.i < len(self.b) else None

    def take(self):
        c = self.b[self.i]
        self.i += 1
        return c

    # -- grammar: alt := concat ('|' concat)* ---------------------------
    def parse(self):
        if self.peek() == ord("^"):
            self.take()
            self.anchored_start = True
        node = self._alt(top=True)
        if isinstance(node, Alt) and (self.anchored_start
                                      or self.anchored_end):
            # Java scopes '^'/'$' to their branch; this compiler anchors
            # the whole pattern — reject instead of mis-matching
            raise RegexUnsupported(
                "anchors with top-level alternation")
        return node

    def _alt(self, top=False):
        opts = [self._concat(top)]
        while self.peek() == ord("|"):
            self.take()
            opts.append(self._concat(top))
        return opts[0] if len(opts) == 1 else Alt(opts)

    def _concat(self, top=False):
        parts = []
        while True:
            c = self.peek()
            if c is None or c in (ord("|"), ord(")")):
                break
            if c == ord("$"):
                # only valid at the very end of the pattern (subset)
                if self.i == len(self.b) - 1 and top:
                    self.take()
                    self.anchored_end = True
                    break
                raise RegexUnsupported("'$' not at pattern end")
            parts.append(self._quantified())
        return Concat(parts)

    def _quantified(self):
        atom = self._atom()
        c = self.peek()
        if c == ord("*"):
            self.take()
            self._no_lazy()
            return Repeat(atom, 0, None)
        if c == ord("+"):
            self.take()
            self._no_lazy()
            return Repeat(atom, 1, None)
        if c == ord("?"):
            self.take()
            self._no_lazy()
            return Repeat(atom, 0, 1)
        if c == ord("{"):
            j = self.b.find(b"}", self.i)
            if j < 0:
                raise RegexSyntaxError("unterminated {..}")
            body = self.b[self.i + 1:j].decode()
            self.i = j + 1
            self._no_lazy()
            import re as _re
            if not _re.fullmatch(r"\d+(,\d*)?", body):
                raise RegexSyntaxError(f"bad repeat {{{body}}}")
            if "," in body:
                lo_s, hi_s = body.split(",", 1)
                lo = int(lo_s)
                hi = int(hi_s) if hi_s else None
            else:
                lo = hi = int(body)
            if hi is not None and hi < lo:
                raise RegexSyntaxError(f"bad repeat bound {{{body}}}")
            if lo > 64 or (hi is not None and hi > 64):
                raise RegexUnsupported("repeat bound > 64")
            return Repeat(atom, lo, hi)
        return atom

    def _no_lazy(self):
        if self.peek() == ord("?"):
            raise RegexUnsupported("lazy quantifiers")
        if self.peek() == ord("+"):
            raise RegexUnsupported("possessive quantifiers")

    def _atom(self):
        c = self.take()
        if c == ord("("):
            if self.b[self.i:self.i + 2] == b"?:":
                self.i += 2
                idx = 0
            elif self.peek() == ord("?"):
                raise RegexUnsupported("(?...) construct")
            else:
                self.ngroups += 1
                idx = self.ngroups
            inner = self._alt()
            if self.peek() != ord(")"):
                raise RegexSyntaxError("unbalanced group")
            self.take()
            return Group(inner, idx)
        if c == ord("["):
            return self._klass()
        if c == ord("."):
            return Klass(ANY_NO_NL)
        if c == ord("\\"):
            return self._escape(in_class=False)
        if c in (ord("*"), ord("+"), ord("?"), ord(")"), ord("]"),
                 ord("{"), ord("}")):
            raise RegexSyntaxError(f"dangling metachar {chr(c)!r}")
        if c == ord("^"):
            raise RegexUnsupported("'^' not at pattern start")
        return Lit(c)

    def _escape(self, in_class: bool):
        if self.peek() is None:
            raise RegexSyntaxError("trailing backslash")
        c = self.take()
        simple = {ord("n"): 10, ord("t"): 9, ord("r"): 13, ord("f"): 12,
                  ord("a"): 7, ord("e"): 27, ord("0"): 0}
        if c in simple:
            return Lit(simple[c])
        if c == ord("d"):
            return Klass(_D)
        if c == ord("D"):
            return Klass(frozenset(range(256)) - _D)
        if c == ord("w"):
            return Klass(_W)
        if c == ord("W"):
            return Klass(frozenset(range(256)) - _W)
        if c == ord("s"):
            return Klass(_S)
        if c == ord("S"):
            return Klass(frozenset(range(256)) - _S)
        if c == ord("x"):
            h = self.b[self.i:self.i + 2]
            try:
                val = int(h, 16)
            except ValueError:
                raise RegexSyntaxError("bad \\x escape")
            if len(h) != 2:
                raise RegexSyntaxError("bad \\x escape")
            self.i += 2
            return Lit(val)
        if chr(c) in ".*+?()[]{}|^$\\/-'\"!#%&,:;<=>@_`~ ":
            return Lit(c)
        if chr(c) in "bBAzZG123456789pPucQEkhHvVRXN":
            # valid Java constructs (boundaries, backrefs, \p classes,
            # \uXXXX, ...) outside the subset -> host fallback
            raise RegexUnsupported(f"escape \\{chr(c)} construct")
        raise RegexSyntaxError(f"escape \\{chr(c)!r}")

    def _klass(self):
        neg = False
        if self.peek() == ord("^"):
            self.take()
            neg = True
        members: Set[int] = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexSyntaxError("unterminated class")
            if c == ord("]") and not first:
                self.take()
                break
            first = False
            self.take()
            if c == ord("\\"):
                atom = self._escape(in_class=True)
                if isinstance(atom, Klass):
                    members |= atom.bytes_in
                    continue
                c = atom.byte
            if self.peek() == ord("-") and self.i + 1 < len(self.b) \
                    and self.b[self.i + 1] != ord("]"):
                self.take()
                hi = self.take()
                if hi == ord("\\"):
                    hi_atom = self._escape(in_class=True)
                    if not isinstance(hi_atom, Lit):
                        raise RegexSyntaxError("class range to a class")
                    hi = hi_atom.byte
                if hi < c:
                    raise RegexSyntaxError("reversed class range")
                members |= set(range(c, hi + 1))
            else:
                members.add(c)
        if neg:
            # Java negated classes DO match \n (unlike `.`)
            members = set(range(256)) - members
        return Klass(frozenset(members))


def parse(pattern: str):
    p = _Parser(pattern)
    ast = p.parse()
    if p.i != len(p.b):
        raise RegexUnsupported(f"trailing characters at {p.i}")
    return ast, p.anchored_start, p.anchored_end, p.ngroups


# ---------------------------------------------------------------------
# Thompson construction over byte classes
# ---------------------------------------------------------------------
@dataclasses.dataclass
class CompiledRegex:
    n_states: int
    start_mask: int              # ε-closure of the start state
    accept_mask: int
    class_table: np.ndarray      # uint8[256] byte -> class id
    n_classes: int
    trans: np.ndarray            # uint32[n_states, n_classes] next-mask
    anchored_start: bool
    anchored_end: bool
    min_len: int
    max_len: Optional[int]       # None = unbounded match length


class _NFA:
    def __init__(self):
        self.edges: List[Tuple[int, frozenset, int]] = []  # (src, cls, dst)
        self.eps: List[Tuple[int, int]] = []
        self.n = 0

    def new_state(self):
        s = self.n
        self.n += 1
        if self.n > MAX_STATES:
            raise RegexUnsupported(f"pattern needs > {MAX_STATES} states")
        return s


def _build(nfa: _NFA, node, src: int, dst: int):
    """Wire `node` to match between states src -> dst."""
    if isinstance(node, Lit):
        nfa.edges.append((src, frozenset([node.byte]), dst))
    elif isinstance(node, Klass):
        if not node.bytes_in:
            raise RegexSyntaxError("empty character class")
        nfa.edges.append((src, node.bytes_in, dst))
    elif isinstance(node, Group):
        _build(nfa, node.child, src, dst)
    elif isinstance(node, Concat):
        cur = src
        for i, part in enumerate(node.parts):
            nxt = dst if i == len(node.parts) - 1 else nfa.new_state()
            _build(nfa, part, cur, nxt)
            cur = nxt
        if not node.parts:
            nfa.eps.append((src, dst))
    elif isinstance(node, Alt):
        for opt in node.options:
            _build(nfa, opt, src, dst)
    elif isinstance(node, Repeat):
        lo, hi = node.lo, node.hi
        cur = src
        for _ in range(lo):
            nxt = nfa.new_state()
            _build(nfa, node.child, cur, nxt)
            cur = nxt
        if hi is None:
            # loop state: child may repeat on cur
            loop_mid = nfa.new_state()
            _build(nfa, node.child, cur, loop_mid)
            nfa.eps.append((loop_mid, cur))
            nfa.eps.append((cur, dst))
        else:
            nfa.eps.append((cur, dst))
            for _ in range(hi - lo):
                nxt = nfa.new_state()
                _build(nfa, node.child, cur, nxt)
                nfa.eps.append((nxt, dst))
                cur = nxt
    else:  # pragma: no cover
        raise RegexUnsupported(f"unknown node {node!r}")


def _len_bounds(node) -> Tuple[int, Optional[int]]:
    if isinstance(node, (Lit, Klass)):
        return 1, 1
    if isinstance(node, Group):
        return _len_bounds(node.child)
    if isinstance(node, Concat):
        lo = hi = 0
        for p in node.parts:
            l2, h2 = _len_bounds(p)
            lo += l2
            hi = None if hi is None or h2 is None else hi + h2
        return lo, hi
    if isinstance(node, Alt):
        los, his = zip(*(_len_bounds(o) for o in node.options))
        hi = None if any(h is None for h in his) else max(his)
        return min(los), hi
    if isinstance(node, Repeat):
        l2, h2 = _len_bounds(node.child)
        lo = l2 * node.lo
        if node.hi is None or h2 is None:
            return lo, None
        return lo, h2 * node.hi
    raise RegexUnsupported(f"unknown node {node!r}")


def compile_nfa(pattern: str) -> CompiledRegex:
    ast, astart, aend, _ = parse(pattern)
    if aend:
        # Java/Python `$` also matches just before a final line
        # terminator: append an optional (\r?\n)
        ast = Concat([ast, Repeat(
            Concat([Repeat(Lit(13), 0, 1), Lit(10)]), 0, 1)])
    nfa = _NFA()
    start = nfa.new_state()
    accept = nfa.new_state()
    _build(nfa, ast, start, accept)
    n = nfa.n

    # ε-closures: fixpoint over eps edges reaches the transitive closure
    closure = [1 << s for s in range(n)]
    changed = True
    while changed:
        changed = False
        for (a, b) in nfa.eps:
            new = closure[a] | closure[b]
            if new != closure[a]:
                closure[a] = new
                changed = True

    # byte equivalence classes over the edge alphabet
    sets = [frozenset(e[1]) for e in nfa.edges]
    class_of_byte = np.zeros(256, np.uint8)
    signatures = {}
    for byte in range(256):
        key = tuple(byte in s for s in sets)
        if key not in signatures:
            signatures[key] = len(signatures)
        class_of_byte[byte] = signatures[key]
    n_classes = len(signatures)
    if n_classes > 64:
        raise RegexUnsupported("too many byte classes")

    trans = np.zeros((n, n_classes), np.uint32)
    class_members = [[] for _ in range(n_classes)]
    for byte in range(256):
        class_members[class_of_byte[byte]].append(byte)
    for (src, cls, dstn) in nfa.edges:
        target = closure[dstn]
        for c_id, members in enumerate(class_members):
            if members[0] in cls:
                trans[src, c_id] |= np.uint32(target & 0xFFFFFFFF)

    mn, mx = _len_bounds(ast)
    return CompiledRegex(
        n_states=n,
        start_mask=closure[start],
        accept_mask=1 << accept,
        class_table=class_of_byte,
        n_classes=n_classes,
        trans=trans,
        anchored_start=astart,
        anchored_end=aend,
        min_len=mn,
        max_len=mx,
    )
