"""Text analysis helpers for the full-text index: stopwords + stemming.

Reference: lib/segment/src/index/field_index/full_text_index/tokenizers/
(stopword filtering, snowball stemmer options). Here: a built-in English
stopword list and a compact Porter(1980)-style stemmer — dependency-free.
"""

from __future__ import annotations

ENGLISH_STOPWORDS = frozenset(
    """a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for from
further had hadn't has hasn't have haven't having he he'd he'll he's her here
here's hers herself him himself his how how's i i'd i'll i'm i've if in into
is isn't it it's its itself let's me more most mustn't my myself no nor not of
off on once only or other ought our ours ourselves out over own same shan't
she she'd she'll she's should shouldn't so some such than that that's the
their theirs them themselves then there there's these they they'd they'll
they're they've this those through to too under until up very was wasn't we
we'd we'll we're we've were weren't what what's when when's where where's
which while who who's whom why why's with won't would wouldn't you you'd
you'll you're you've your yours yourself yourselves""".split()
)

STOPWORDS = {"english": ENGLISH_STOPWORDS}

_VOWELS = set("aeiou")


def _is_consonant(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_consonant(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Porter's m: number of VC sequences."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        vowel = not _is_consonant(stem, i)
        if not vowel and prev_vowel:
            m += 1
        prev_vowel = vowel
    return m


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return (
        len(word) >= 2
        and word[-1] == word[-2]
        and _is_consonant(word, len(word) - 1)
    )


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (
        _is_consonant(word, len(word) - 3)
        and not _is_consonant(word, len(word) - 2)
        and _is_consonant(word, len(word) - 1)
        and word[-1] not in "wxy"
    )


def porter_stem(word: str) -> str:
    """Compact Porter stemmer (steps 1a-5b)."""
    if len(word) <= 2:
        return word
    w = word

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]

    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif (w.endswith("ed") and _contains_vowel(w[:-2])) or (
        w.endswith("ing") and _contains_vowel(w[:-3])
    ):
        w = w[:-2] if w.endswith("ed") else w[:-3]
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_consonant(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"

    # step 1c
    if w.endswith("y") and _contains_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    for suffix, repl in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ):
        if w.endswith(suffix):
            stem = w[: -len(suffix)]
            if _measure(stem) > 0:
                w = stem + repl
            break

    # step 3
    for suffix, repl in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        if w.endswith(suffix):
            stem = w[: -len(suffix)]
            if _measure(stem) > 0:
                w = stem + repl
            break

    # step 4
    for suffix in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ):
        if w.endswith(suffix):
            stem = w[: -len(suffix)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st":
            stem = w[:-3]
            if _measure(stem) > 1:
                w = stem

    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_consonant(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# ASCII folding (reference: tokenizers/ascii_folding.rs, Lucene's
# ASCIIFoldingFilter mapping): NFKD decomposition drops combining marks for
# the bulk of Latin diacritics; the table below covers the characters whose
# folding is not a decomposition.
# ---------------------------------------------------------------------------

_FOLD_EXTRA = {
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE", "ß": "ss", "ẞ": "SS",
    "ø": "o", "Ø": "O", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "TH", "ł": "l", "Ł": "L", "ħ": "h", "Ħ": "H",
    "ı": "i", "ĸ": "k", "ŋ": "n", "Ŋ": "N", "ŧ": "t", "Ŧ": "T",
    "ƒ": "f", "Ɖ": "D", "ǝ": "e", "ȝ": "y", "Ȝ": "Y",
}


def fold_to_ascii(text: str) -> str:
    """Fold non-ASCII latin letters/symbols to ASCII equivalents."""
    if text.isascii():
        return text
    import unicodedata

    out = []
    for ch in text:
        if ch.isascii():
            out.append(ch)
            continue
        if ch in _FOLD_EXTRA:
            out.append(_FOLD_EXTRA[ch])
            continue
        decomp = unicodedata.normalize("NFKD", ch)
        kept = "".join(c for c in decomp if not unicodedata.combining(c))
        out.append(kept if kept.isascii() else ch)
    return "".join(out)


# ---------------------------------------------------------------------------
# Multilingual segmentation (reference: tokenizers/multilingual.rs +
# japanese.rs). Latin/Cyrillic/etc. scripts segment on word boundaries. CJK
# runs — where the reference runs dictionary morphological segmentation
# (lindera/vaporetto) — use a dictionary-less approximation: Japanese runs
# split at script-class boundaries (kanji|hiragana|katakana, which in real
# text track morpheme boundaries closely: 東京で働く → 東京 | で | 働 | く),
# katakana loanwords stay whole words, and han/hangul runs render as
# character bigrams (the standard n-gram fallback). Both index and query
# sides tokenize identically, so phrase positions stay consistent.
# ---------------------------------------------------------------------------

def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (
        0x2E80 <= cp <= 0x9FFF  # CJK radicals .. unified ideographs
        or 0x3040 <= cp <= 0x30FF  # hiragana + katakana
        or 0xAC00 <= cp <= 0xD7AF  # hangul syllables
        or 0xF900 <= cp <= 0xFAFF  # CJK compat ideographs
        or 0x20000 <= cp <= 0x2FA1F  # extensions
    )


def segment_multilingual(text: str) -> list:
    """→ tokens: unicode words for alphabetic scripts, char bigrams for CJK
    runs (single char when the run length is 1)."""
    import re as _re
    import unicodedata

    text = unicodedata.normalize("NFKC", text)
    tokens = []
    for m in _re.finditer(r"[^\W_]+", text, _re.UNICODE):
        word = m.group(0)
        run: list = []
        run_cjk = False
        for ch in word:
            cjk = _is_cjk(ch)
            if run and cjk != run_cjk:
                tokens.extend(_emit_cjk(run) if run_cjk else ["".join(run)])
                run = []
            run.append(ch)
            run_cjk = cjk
        if run:
            tokens.extend(_emit_cjk(run) if run_cjk else ["".join(run)])
    return tokens


def _script_class(ch: str) -> str:
    cp = ord(ch)
    if 0x3040 <= cp <= 0x309F:
        return "hira"
    if 0x30A0 <= cp <= 0x30FF or cp == 0xFF70:  # katakana incl. ー
        return "kata"
    if 0xAC00 <= cp <= 0xD7AF:
        return "hangul"
    return "han"


def _bigrams(seg: str) -> list:
    if len(seg) == 1:
        return [seg]
    return [seg[i : i + 2] for i in range(len(seg) - 1)]


def _emit_cjk(run: list) -> list:
    """Segment one CJK run. Script-class boundaries split Japanese into
    morpheme-ish units (reference behavior: tokenizers/japanese.rs via a
    dictionary model; here dictionary-less): katakana sub-runs are emitted
    whole (loanwords), hiragana sub-runs ≤2 chars whole (particles /
    inflections) else bigrams, kanji/hangul sub-runs as bigrams."""
    s = "".join(run)
    out: list = []
    i = 0
    while i < len(s):
        cls = _script_class(s[i])
        j = i + 1
        while j < len(s) and _script_class(s[j]) == cls:
            j += 1
        seg = s[i:j]
        if cls == "kata":
            out.append(seg)
        elif cls == "hira" and len(seg) <= 2:
            out.append(seg)
        else:
            out.extend(_bigrams(seg))
        i = j
    return out
