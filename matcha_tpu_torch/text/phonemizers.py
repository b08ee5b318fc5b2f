"""Text → phoneme-ID frontend.

Host-side (CPU) pipeline, mirroring the reference behaviour
(reference: matcha/text/phonemizers.py):

    raw text
      → NeMo text normalization        (en/es/pt/de/fr/it; optional dep)
      → regex cleanup                  (cleanup_text, pure)
      → eSpeak-ng IPA phonemization    (10 languages; optional dep)
      → silence-space injection        (LEADING/TRAILING_SILENCE_SPACES)
      → tokenization                   (tokenize_phonemes, pure)

The accelerator never sees text: this module produces int32 ID sequences that
feed the synthesis graph.  Every *voiced* phoneme P expands to the triple
(PRE_ID+P, P, POST_ID+P) so the encoder can model co-articulation transitions
explicitly (reference: matcha/text/phonemizers.py:140-152).

eSpeak-ng and NeMo are C/FST libraries that only exist on the host; they are
imported lazily so the compute path (and the test-suite) never requires them.
"""

from __future__ import annotations

import logging
import os
import re
from functools import lru_cache
from pathlib import Path

from matcha_tpu_torch.text.symbols import PRE_ID, POST_ID, symbol_to_id, voiced_phoneme_ids

logger = logging.getLogger(__name__)

SUPPORTED_LANGUAGES = ("en-us", "en-gb", "ro", "fr-fr", "de", "es", "pt", "it", "ja", "he")
NEMO_LANGUAGES = ("en", "es", "pt", "de", "fr", "it")

# Silence anchors injected after eSpeak runs (it collapses edge whitespace).
# Corpus wavs are silence-normalized, so each injected space owns a stable
# share of mel frames after alignment (reference: phonemizers.py:54-66).
LEADING_SILENCE_SPACES = 1
TRAILING_SILENCE_SPACES = 0


# ---------------------------------------------------------------------------
# Pure text processing (hermetic, no external deps)
# ---------------------------------------------------------------------------

def cleanup_text(text: str) -> str:
    """Regex cleanup applied between normalization and phonemization.

    Behavioural contract (reference: phonemizers.py:69-81, specified by
    tests/test_phonemizers.py): strip quote-like characters, turn bracketing
    or dash-like symbols into a comma+space pause, collapse comma runs, drop
    commas that collide with sentence punctuation, and guarantee terminal
    punctuation.
    """
    text = re.sub('["„“”«»¡¿]', "", text)
    text = re.sub(r"\s*[,<>()\[\]{}—–…]\s*", ", ", text)
    text = re.sub(r"\s+([.?!,;:])", r"\1", text)  # no spaces before punctuation
    text = re.sub(r"^,\s*", "", text)  # no leading comma
    text = re.sub(r",\s*,", ",", text)  # no comma runs
    text = re.sub(r",\s*([.?!])", r"\1", text)  # no comma before sentence end

    text = text.strip()
    if not text.endswith((".", "?", "!")):
        text += "."
    return text


def emphasize_intonation_marks(text: str) -> str:
    """Double lone '?' so rising intonation is clearly audible.

    Runs of 2+ marks and mixed pairs like '?!' are left untouched
    (reference: matcha/inference.py:200-209).  Idempotent.
    """
    return re.sub(r"(?<![?!])\?(?![?!])", "??", text)


def tokenize_phonemes(phonemes: str) -> tuple[str, list[int]]:
    """Map an IPA string to model IDs with (pre, P, post) voiced expansion.

    Returns ``(debug_string, ids)`` where the debug string marks expanded
    voiced phonemes as ``‹P›`` (display only).  Raises ``KeyError`` for
    symbols outside the frozen inventory — corpus validation catches those
    up-front (see the corpus IPA validator of the JAX package).
    """
    ids: list[int] = []
    debug: list[str] = []
    for ch in phonemes:
        pid = symbol_to_id[ch]
        if pid in voiced_phoneme_ids:
            ids.extend((PRE_ID + pid, pid, POST_ID + pid))
            debug.extend(("‹", ch, "›"))
        else:
            ids.append(pid)
            debug.append(ch)
    return "".join(debug), ids


# ---------------------------------------------------------------------------
# Optional host-side C/FST dependencies, lazily initialized
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _get_normalizer(lang_code: str):
    if lang_code not in NEMO_LANGUAGES:
        return None
    try:
        from nemo_text_processing.text_normalization.normalize import Normalizer
    except ImportError:
        logger.warning("nemo_text_processing not installed; skipping normalization")
        return None
    cache_base = Path(os.environ.get("MATCHA_CACHE_DIR", Path.cwd() / ".cache"))
    cache_dir = cache_base / "nemo" / "grammars"
    cache_dir.mkdir(parents=True, exist_ok=True)
    try:
        return Normalizer(input_case="cased", lang=lang_code, cache_dir=str(cache_dir))
    except Exception as exc:  # pragma: no cover - depends on grammar downloads
        logger.warning("NeMo normalizer unavailable for %s: %s", lang_code, exc)
        return None


@lru_cache(maxsize=None)
def _get_espeak_backend(language: str):
    if language not in SUPPORTED_LANGUAGES:
        raise ValueError(f"Unsupported {language=}")
    try:
        import phonemizer as _phonemizer
    except ImportError as exc:
        raise RuntimeError(
            "The 'phonemizer' package (eSpeak-ng backend) is required for raw-text "
            "input. Install matcha-tts-24k-tpu[text], or feed precomputed phoneme "
            "IDs (see tokenize_phonemes)."
        ) from exc
    espeak_logger = logging.getLogger("phonemizer")
    espeak_logger.setLevel(logging.ERROR)  # eSpeak is very verbose
    return _phonemizer.backend.EspeakBackend(
        language=language,
        preserve_punctuation=True,
        with_stress=True,
        language_switch="remove-flags",
        logger=espeak_logger,
    )


def normalize_text(lang_code: str, text: str) -> str:
    """NeMo text normalization (numbers, abbreviations, ...), if available.

    The smart left single quote confuses NeMo, so it is removed up-front;
    the right one doubles as an apostrophe and is handled fine by eSpeak
    (reference: phonemizers.py:88-95).
    """
    text = text.replace("‘", "")
    normalizer = _get_normalizer(lang_code)
    if normalizer is not None:
        text = normalizer.normalize(text)
    return text


def phonemize(text: str, language: str) -> str:
    """Raw text → IPA string with silence-space anchors injected."""
    backend = _get_espeak_backend(language)
    ipa = backend.phonemize([text])[0].rstrip()
    return " " * LEADING_SILENCE_SPACES + ipa + " " * TRAILING_SILENCE_SPACES


def multilingual_phonemizer(text: str, language: str) -> tuple[str, list[int]]:
    """Full frontend: normalize → cleanup → eSpeak → tokenize.

    Same contract as the reference entry point (phonemizers.py:96-152):
    returns ``(debug_string, phoneme_ids)``.
    """
    if language not in SUPPORTED_LANGUAGES:
        raise ValueError(f"Unsupported {language=}")
    lang_code = language.split("-")[0]
    text = normalize_text(lang_code, text)
    text = cleanup_text(text)
    phonemes = phonemize(text, language)
    return tokenize_phonemes(phonemes)


# ---------------------------------------------------------------------------
# Deployment selftest: python -m matcha_tpu_torch.text.phonemizers --selftest
# ---------------------------------------------------------------------------

SELFTEST_SENTENCES = {
    "en-us": "Dr. Smith paid $12.50 on March 3rd, 2021?",
    "en-gb": "The colour of the 2nd lorry was grey.",
    "ro": "Astăzi este o zi frumoasă de vară.",
    "fr-fr": "Il fait très beau aujourd'hui, n'est-ce pas ?",
    "de": "Heute ist der 3. Oktober und es regnet.",
    "es": "¿Cuánto cuesta el billete de tren a Madrid?",
    "pt": "O comboio chega às 15 horas e 30 minutos.",
    "it": "Oggi è una bellissima giornata di primavera!",
    "ja": "今日はいい天気ですね。",
    "he": "היום יום יפה מאוד.",
}


def validate_triple_structure(ids: list[int]) -> None:
    """Assert the (pre, P, post) voiced-expansion invariant over an ID list.

    Every voiced base phoneme must sit between exactly PRE_ID+P and
    POST_ID+P, and every PRE/POST token must flank its own base phoneme
    (reference contract: matcha/text/phonemizers.py:140-152; exercised by
    the reference's TestPhonemeIds, tests/test_phonemizers.py:290-327).
    """
    for i, pid in enumerate(ids):
        if pid in voiced_phoneme_ids:
            if i == 0 or ids[i - 1] != PRE_ID + pid:
                raise AssertionError(f"voiced id {pid} at {i} lacks PRE token")
            if i + 1 >= len(ids) or ids[i + 1] != POST_ID + pid:
                raise AssertionError(f"voiced id {pid} at {i} lacks POST token")
        elif PRE_ID <= pid < POST_ID:
            if i + 1 >= len(ids) or ids[i + 1] != pid - PRE_ID:
                raise AssertionError(f"dangling PRE token {pid} at {i}")
        elif pid >= POST_ID:
            if i == 0 or ids[i - 1] != pid - POST_ID:
                raise AssertionError(f"dangling POST token {pid} at {i}")


# Live-NeMo assertion set: exact normalizer outputs the reference pins in
# its (non-hermetic) test suite (reference: tests/test_phonemizers.py:127-171).
# These are expected outputs of the third-party NeMo FST grammars — a
# behavioural contract, exercised only where nemo_text_processing exists
# (the --require-nemo Docker build gate, RELEASE.md §5).
NEMO_SNAPSHOTS: dict[str, list[tuple[str, str]]] = {
    "en": [
        (
            "Dr. Jones will see you at 15:00.",
            "doctor Jones will see you at fifteen o'clock.",
        ),
        (
            "The price is $5.00 as of Jan 21st, 2026.",
            "The price is five dollars as of january twenty first, "
            "twenty twenty six.",
        ),
        (
            "He scored 95% on the test.",
            "He scored ninety five percent on the test.",
        ),
        # the left smart quote is stripped pre-NeMo; the right one is kept
        ("He said hello ‘back’.", "He said hello back’."),
        ("Word   ", "Word"),
    ],
    "de": [
        (
            "Dr. Müller sieht Sie um 15:00 Uhr.",
            "doktor Müller sieht Sie um fünfzehn uhr .",
        ),
    ],
    "it": [
        (
            "Il Dr. Rossi la vedrà alle 15:00.",
            "Il dottor Rossi la vedrà alle quindici .",
        ),
    ],
    "es": [
        (
            "El Dr. García llegará a las 15:00.",
            "El Doctor García llegará a las quince .",
        ),
    ],
    "fr": [
        # NeMo fr does not expand Dr. — pin the no-op too
        (
            "Le Dr. Dupont vous verra à 15h00.",
            "Le Dr. Dupont vous verra à 15h00.",
        ),
    ],
}


def nemo_selftest(languages=None) -> None:
    """LIVE NeMo normalization gate: require the package and assert the
    reference's normalization snapshots verbatim.  Unlike ``selftest`` (which
    degrades gracefully when NeMo is absent), this RAISES if
    nemo_text_processing is missing — wire it behind a Docker build arg
    (docker/Dockerfile REQUIRE_NEMO=1)."""
    try:
        import nemo_text_processing  # noqa: F401
    except ImportError as exc:
        raise RuntimeError(
            "--require-nemo: nemo_text_processing is not installed; the live "
            "normalization path cannot be verified"
        ) from exc
    # accept full language tags ("en-us") and keep only snapshotted bases
    bases = [l.split("-")[0] for l in (languages or list(NEMO_SNAPSHOTS))]
    langs = [l for l in dict.fromkeys(bases) if l in NEMO_SNAPSHOTS]
    if not langs:
        raise ValueError(f"no NeMo snapshots for languages {languages}")
    for lang in langs:
        if _get_normalizer(lang) is None:
            raise RuntimeError(f"--require-nemo: normalizer failed to build for {lang}")
        for raw, expected in NEMO_SNAPSHOTS[lang]:
            got = normalize_text(lang, raw)
            if got != expected:
                raise AssertionError(
                    f"NeMo normalization drift [{lang}]: {raw!r} -> {got!r}, "
                    f"expected {expected!r}"
                )
        print(f"nemo selftest {lang}: {len(NEMO_SNAPSHOTS[lang])} snapshots ok")
    print(f"nemo selftest: all {len(langs)} languages ok")


def selftest(languages=SUPPORTED_LANGUAGES) -> None:
    """Phonemize one sentence per language through the LIVE eSpeak/NeMo path
    and validate the output structure.  Raises on any failure — intended as
    a Docker build-time gate so the only environment-dependent frontend path
    gets exercised wherever the native libs exist."""
    from matcha_tpu_torch.text.symbols import SPACE_ID

    for language in languages:
        debug, ids = multilingual_phonemizer(SELFTEST_SENTENCES[language], language)
        if len(ids) < 5:
            raise AssertionError(f"{language}: suspiciously short output {ids}")
        if ids[0] != SPACE_ID:
            raise AssertionError(f"{language}: missing leading silence space")
        validate_triple_structure(ids)
        if not any(pid in voiced_phoneme_ids for pid in ids):
            raise AssertionError(f"{language}: no voiced phonemes produced")
        print(f"selftest {language}: ok ({len(ids)} ids) {debug[:60]!r}")
    print(f"selftest: all {len(languages)} languages ok")


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--selftest", action="store_true")
    parser.add_argument(
        "--require-nemo",
        action="store_true",
        help="fail (don't degrade) without nemo_text_processing, and assert "
        "the reference's normalization snapshots against the live grammars",
    )
    parser.add_argument("--lang", action="append", help="restrict languages")
    args = parser.parse_args()
    if args.require_nemo:
        nemo_selftest(tuple(args.lang) if args.lang else None)
    if args.selftest:
        selftest(tuple(args.lang) if args.lang else SUPPORTED_LANGUAGES)
