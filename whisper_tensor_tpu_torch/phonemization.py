"""Phonemization: text -> IPA, + per-TTS-model phoneme-id mappings.

Reference equivalent: src/phonemization.rs (native IPA backend +
optional espeak-ng, Piper + Kokoro mappings, env-var backend select).
Here: a rule-based English G2P — exceptions lexicon, context-sensitive
letter rules (c/g softening, magic-e, voiced th, silent clusters),
number expansion, punctuation pass-through — plus an espeak-ng
subprocess hook when present. Backend via WT_PHONEMIZER
(auto | espeak | builtin).

The port's copy of whisper_tensor_tpu/phonemization.py, unchanged: the
TTS interfaces and the super graph's phoneme nodes run it on the host.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, List, Optional

# ---------------------------------------------------------------------------
# exceptions lexicon: common English words whose spelling is irregular
# enough that letter rules mangle them (function words first — they
# dominate running text, so lexicon hits carry most of the quality)
# ---------------------------------------------------------------------------
_LEXICON = {
    "a": "ə", "an": "æn", "and": "ænd", "the": "ðə", "of": "əv",
    "to": "tuː", "in": "ɪn", "is": "ɪz", "was": "wʌz", "are": "ɑːɹ",
    "be": "biː", "been": "bɪn", "being": "biːɪŋ", "am": "æm",
    "i": "aɪ", "you": "juː", "he": "hiː", "she": "ʃiː", "it": "ɪt",
    "we": "wiː", "they": "ðeɪ", "them": "ðɛm", "their": "ðɛɹ",
    "there": "ðɛɹ", "these": "ðiːz", "this": "ðɪs", "that": "ðæt",
    "those": "ðoʊz", "then": "ðɛn", "than": "ðæn", "though": "ðoʊ",
    "through": "θɹuː", "thought": "θɔːt", "thorough": "θɜːɹoʊ",
    "as": "æz", "at": "æt", "by": "baɪ", "for": "fɔːɹ", "from": "fɹʌm",
    "have": "hæv", "has": "hæz", "had": "hæd", "do": "duː",
    "does": "dʌz", "done": "dʌn", "don't": "doʊnt", "what": "wʌt",
    "who": "huː", "whom": "huːm", "whose": "huːz", "where": "wɛɹ",
    "were": "wɚ", "with": "wɪθ", "would": "wʊd", "could": "kʊd",
    "should": "ʃʊd", "your": "jɔːɹ", "my": "maɪ", "me": "miː",
    "said": "sɛd", "says": "sɛz", "any": "ɛni", "many": "mɛni",
    "some": "sʌm", "come": "kʌm", "someone": "sʌmwʌn", "once": "wʌns",
    "only": "oʊnli", "very": "vɛɹi", "every": "ɛvɹi",
    "people": "piːpəl", "water": "wɔːtɚ", "again": "əɡɛn",
    "against": "əɡɛnst", "because": "bɪkʌz", "before": "bɪfɔːɹ",
    "after": "æftɚ", "above": "əbʌv", "about": "əbaʊt",
    "other": "ʌðɚ", "another": "ənʌðɚ", "mother": "mʌðɚ",
    "father": "fɑːðɚ", "brother": "bɹʌðɚ", "together": "təɡɛðɚ",
    "weather": "wɛðɚ", "whether": "wɛðɚ", "rather": "ɹæðɚ",
    "either": "iːðɚ", "neither": "niːðɚ", "further": "fɜːðɚ",
    "one": "wʌn", "two": "tuː", "three": "θɹiː", "four": "fɔːɹ",
    "five": "faɪv", "six": "sɪks", "seven": "sɛvən", "eight": "eɪt",
    "nine": "naɪn", "ten": "tɛn", "zero": "zɪɹoʊ",
    "eleven": "ɪlɛvən", "twelve": "twɛlv", "twenty": "twɛnti",
    "thirty": "θɜːti", "forty": "fɔːɹti", "fifty": "fɪfti",
    "hundred": "hʌndɹəd", "thousand": "θaʊzənd", "million": "mɪljən",
    "billion": "bɪljən", "first": "fɜːst", "second": "sɛkənd",
    "third": "θɜːd", "half": "hæf",
    "love": "lʌv", "give": "ɡɪv", "live": "lɪv", "move": "muːv",
    "gone": "ɡɔːn", "none": "nʌn", "nothing": "nʌθɪŋ",
    "something": "sʌmθɪŋ", "anything": "ɛniθɪŋ",
    "world": "wɜːld", "word": "wɜːd", "work": "wɜːk",
    "woman": "wʊmən", "women": "wɪmɪn", "eye": "aɪ", "eyes": "aɪz",
    "heart": "hɑːɹt", "earth": "ɜːθ", "hour": "aʊɚ", "honest": "ɑːnɪst",
    "island": "aɪlənd", "answer": "ænsɚ", "often": "ɔːfən",
    "listen": "lɪsən", "know": "noʊ", "knew": "nuː", "known": "noʊn",
    "now": "naʊ", "how": "haʊ", "down": "daʊn", "town": "taʊn",
    "new": "nuː", "few": "fjuː", "view": "vjuː",
    "here": "hɪɹ", "more": "mɔːɹ", "most": "moʊst", "both": "boʊθ",
    "old": "oʊld", "cold": "koʊld", "hold": "hoʊld",
    "also": "ɔːlsoʊ", "always": "ɔːlweɪz", "almost": "ɔːlmoʊst",
    "walk": "wɔːk", "talk": "tɔːk", "want": "wɑːnt", "warm": "wɔːɹm",
    "war": "wɔːɹ", "watch": "wɑːtʃ",
    "great": "ɡɹeɪt", "break": "bɹeɪk", "steak": "steɪk",
    "friend": "fɹɛnd", "heard": "hɜːd", "learn": "lɜːn",
    "early": "ɜːli", "heavy": "hɛvi", "ready": "ɹɛdi", "head": "hɛd",
    "dead": "dɛd", "bread": "bɹɛd", "instead": "ɪnstɛd",
    "laugh": "læf", "enough": "ɪnʌf", "rough": "ɹʌf", "tough": "tʌf",
    "cough": "kɔːf", "caught": "kɔːt", "daughter": "dɔːtɚ",
    "night": "naɪt", "light": "laɪt", "right": "ɹaɪt",
    "says'": "sɛz", "busy": "bɪzi", "business": "bɪznəs",
    "beautiful": "bjuːtɪfəl", "language": "læŋɡwɪdʒ",
    "machine": "məʃiːn", "technology": "tɛknɑːlədʒi",
    "science": "saɪəns", "ocean": "oʊʃən", "special": "spɛʃəl",
    "social": "soʊʃəl", "sure": "ʃʊɹ", "sugar": "ʃʊɡɚ",
    "usual": "juːʒuəl", "usually": "juːʒuəli", "measure": "mɛʒɚ",
    "pleasure": "plɛʒɚ", "vision": "vɪʒən", "question": "kwɛstʃən",
}

# voiced-th function words beyond the lexicon (suffix-tolerant stems)
_VOICED_TH_PREFIX = ("the", "thi", "tha", "tho", "thu", "they", "them")

_DIGIT_WORDS = {
    "0": "zero", "1": "one", "2": "two", "3": "three", "4": "four",
    "5": "five", "6": "six", "7": "seven", "8": "eight", "9": "nine",
}

_PUNCT = set(".,!?;:…—-()\"'")

_VOWELS = set("aeiouy")


def _word_to_ipa(word: str) -> str:
    w = word.strip("'")
    if not w:
        return ""
    hit = _LEXICON.get(w)
    if hit is not None:
        return hit
    # suffix-stripped lexicon retry (plural/past/progressive)
    for suf, tail in (("s", "z"), ("ed", "d"), ("ing", "ɪŋ")):
        if w.endswith(suf) and len(w) > len(suf) + 1 and w[:-len(suf)] in _LEXICON:
            return _LEXICON[w[:-len(suf)]] + tail
    return _rules_to_ipa(w)


def _rules_to_ipa(w: str) -> str:  # noqa: C901 - the rule table IS the function
    out: List[str] = []
    n = len(w)
    # magic-e: final silent e lengthens the previous stressed vowel
    magic_e = (n >= 3 and w.endswith("e") and w[-2] not in _VOWELS
               and w[-3] in _VOWELS and w[-2] not in "wx")
    long_vowel_pos = n - 3 if magic_e else -1
    i = 0
    while i < n:
        rest = w[i:]
        nxt = w[i + 1] if i + 1 < n else ""
        # silent final e
        if magic_e and i == n - 1:
            break
        # --- multi-letter clusters -------------------------------------
        if rest.startswith("tion") or rest.startswith("cian"):
            out.append("ʃən"); i += 4; continue
        if rest.startswith("sion"):
            out.append("ʒən" if i > 0 and w[i - 1] in _VOWELS else "ʃən")
            i += 4; continue
        if rest.startswith("ture") and i + 4 >= n:
            out.append("tʃɚ"); i += 4; continue
        if rest.startswith("ough"):
            out.append("ʌf"); i += 4; continue
        if rest.startswith("augh"):
            out.append("ɔː"); i += 4; continue
        if rest.startswith("eigh"):
            out.append("eɪ"); i += 4; continue
        if rest.startswith("igh"):
            out.append("aɪ"); i += 3; continue
        if rest.startswith("tch"):
            out.append("tʃ"); i += 3; continue
        if rest.startswith("dge"):
            out.append("dʒ"); i += 3; continue
        if rest.startswith("sch"):
            out.append("sk"); i += 3; continue
        if i == 0 and rest.startswith("kn"):
            out.append("n"); i += 2; continue
        if i == 0 and rest.startswith("wr"):
            out.append("ɹ"); i += 2; continue
        if i == 0 and rest.startswith("ps"):
            out.append("s"); i += 2; continue
        if i == 0 and rest.startswith("gn"):
            out.append("n"); i += 2; continue
        if rest.startswith("mb") and i + 2 >= n:
            out.append("m"); i += 2; continue
        if rest.startswith("ch"):
            out.append("tʃ"); i += 2; continue
        if rest.startswith("sh"):
            out.append("ʃ"); i += 2; continue
        if rest.startswith("zh"):
            out.append("ʒ"); i += 2; continue
        if rest.startswith("ph"):
            out.append("f"); i += 2; continue
        if rest.startswith("wh"):
            out.append("w"); i += 2; continue
        if rest.startswith("th"):
            out.append("ð" if w.startswith(_VOICED_TH_PREFIX) else "θ")
            i += 2; continue
        if rest.startswith("ng") and i + 2 >= n:
            out.append("ŋ"); i += 2; continue
        if rest.startswith("nk"):
            out.append("ŋk"); i += 2; continue
        if rest.startswith("ck"):
            out.append("k"); i += 2; continue
        if rest.startswith("qu"):
            out.append("kw"); i += 2; continue
        # --- vowel digraphs ---------------------------------------------
        for pat, ipa in (("ee", "iː"), ("ea", "iː"), ("oo", "uː"),
                         ("ou", "aʊ"), ("ow", "oʊ"), ("ai", "eɪ"),
                         ("ay", "eɪ"), ("ey", "eɪ"), ("oi", "ɔɪ"),
                         ("oy", "ɔɪ"), ("au", "ɔː"), ("aw", "ɔː"),
                         ("ie", "iː"), ("oa", "oʊ"), ("ue", "uː"),
                         ("ui", "uː"), ("eu", "juː"), ("ew", "uː")):
            if rest.startswith(pat):
                out.append(ipa)
                i += 2
                break
        else:
            # --- r-colored vowels ----------------------------------------
            for pat, ipa in (("ar", "ɑːɹ"), ("er", "ɚ"), ("ir", "ɜː"),
                             ("or", "ɔːɹ"), ("ur", "ɜː")):
                if rest.startswith(pat) and (i + 2 >= n
                                             or w[i + 2] not in _VOWELS):
                    out.append(ipa)
                    i += 2
                    break
            else:
                c = w[i]
                if c == "c":
                    out.append("s" if nxt in "eiy" else "k")
                elif c == "g":
                    out.append("dʒ" if nxt in "eiy" else "ɡ")
                elif c == "s" and 0 < i < n - 1 and w[i - 1] in _VOWELS \
                        and nxt in _VOWELS:
                    out.append("z")          # intervocalic s voices
                elif c == "x":
                    out.append("z" if i == 0 else "ks")
                elif c == "y":
                    out.append("j" if i == 0 else
                               ("aɪ" if i == n - 1 and n <= 3 else "i"))
                elif c in _VOWELS:
                    long_map = {"a": "eɪ", "e": "iː", "i": "aɪ",
                                "o": "oʊ", "u": "juː", "y": "aɪ"}
                    short_map = {"a": "æ", "e": "ɛ", "i": "ɪ",
                                 "o": "ɑː", "u": "ʌ", "y": "ɪ"}
                    if i == long_vowel_pos:
                        out.append(long_map[c])
                    elif c == "e" and i == n - 1:
                        pass                  # final e is silent
                    else:
                        out.append(short_map[c])
                else:
                    single = {"b": "b", "d": "d", "f": "f", "h": "h",
                              "j": "dʒ", "k": "k", "l": "l", "m": "m",
                              "n": "n", "p": "p", "q": "k", "r": "ɹ",
                              "s": "s", "t": "t", "v": "v", "w": "w",
                              "z": "z"}
                    out.append(single.get(c, ""))
                i += 1
    return "".join(out)


def _expand_number(tok: str) -> List[str]:
    """Digit string -> English words (groups of thousands up to billions)."""
    try:
        val = int(tok)
    except ValueError:
        return [_DIGIT_WORDS.get(ch, "") for ch in tok if ch in _DIGIT_WORDS]
    if val < 0:
        return ["minus"] + _expand_number(str(-val))
    ones = ["zero", "one", "two", "three", "four", "five", "six", "seven",
            "eight", "nine", "ten", "eleven", "twelve", "thirteen",
            "fourteen", "fifteen", "sixteen", "seventeen", "eighteen",
            "nineteen"]
    tens = ["", "", "twenty", "thirty", "forty", "fifty", "sixty",
            "seventy", "eighty", "ninety"]

    def under_thousand(v: int) -> List[str]:
        words: List[str] = []
        if v >= 100:
            words += [ones[v // 100], "hundred"]
            v %= 100
        if v >= 20:
            words.append(tens[v // 10])
            v %= 10
        if 0 < v < 20:
            words.append(ones[v])
        return words or (["zero"] if not words else words)

    if val < 1000:
        return under_thousand(val) if val else ["zero"]
    parts: List[str] = []
    for scale, name in ((10 ** 9, "billion"), (10 ** 6, "million"),
                        (10 ** 3, "thousand")):
        if val >= scale:
            parts += under_thousand(val // scale) + [name]
            val %= scale
    if val:
        parts += under_thousand(val)
    return parts


def _builtin_phonemize(text: str) -> str:
    tokens: List[str] = []
    word = ""
    digits = ""

    def flush_word():
        nonlocal word
        if word:
            ipa = _word_to_ipa(word.lower())
            if ipa:
                tokens.append(ipa)
            word = ""

    def flush_digits():
        nonlocal digits
        if digits:
            for wtok in _expand_number(digits):
                ipa = _word_to_ipa(wtok)
                if ipa:
                    tokens.append(ipa)
            digits = ""

    for ch in text:
        if ch.isalpha() or ch == "'":
            flush_digits()
            word += ch
        elif ch.isdigit():
            flush_word()
            digits += ch
        else:
            flush_word()
            flush_digits()
            if ch in _PUNCT:
                tokens.append(ch)
    flush_word()
    flush_digits()
    return " ".join(tokens)


def _espeak_phonemize(text: str, language: str) -> str:
    exe = shutil.which("espeak-ng") or shutil.which("espeak")
    result = subprocess.run(
        [exe, "-q", "--ipa", "-v", language, text],
        capture_output=True, text=True, timeout=30)
    return result.stdout.strip()


def phonemize(text: str, language: str = "en-us") -> str:
    backend = os.environ.get("WT_PHONEMIZER", "auto")
    if backend in ("espeak", "auto") and (shutil.which("espeak-ng")
                                          or shutil.which("espeak")):
        try:
            return _espeak_phonemize(text, language)
        except Exception:
            if backend == "espeak":
                raise
    return _builtin_phonemize(text)


# ---------------------------------------------------------------------------
# Piper: phoneme string -> ids via the model's phoneme_id_map, with
# pad (0) interleaving and BOS(1)/EOS(2) per piper convention.
# ---------------------------------------------------------------------------


def piper_phoneme_ids(phonemes: str, phoneme_id_map: Optional[Dict[str, List[int]]]
                      ) -> List[int]:
    pid = phoneme_id_map or {}

    def lookup(ch: str) -> List[int]:
        v = pid.get(ch)
        if v is None:
            return []
        return v if isinstance(v, list) else [v]

    ids: List[int] = []
    ids += lookup("^") or [1]
    ids += lookup("_") or [0]
    for ch in phonemes:
        got = lookup(ch)
        if not got:
            continue
        ids += got
        ids += lookup("_") or [0]
    ids += lookup("$") or [2]
    return ids


def kokoro_phoneme_ids(phonemes: str, vocab: Optional[Dict[str, int]]) -> List[int]:
    v = vocab or {}
    ids = [0]  # BOS pad
    for ch in phonemes:
        if ch in v:
            ids.append(v[ch])
    ids.append(0)
    return ids
