"""HTTP TTS server: OpenAI-style speech endpoint on the card.

Endpoint surface mirrors the reference FastAPI server
(reference: matcha/server.py):

  POST /v1/audio/speech   (+ aliases /audio/speech, /v1/tts, /tts)
      {"input": str, "voice": "2" | "2(70)+6(30)", "response_format":
       "mp3"|"wav"|"pcm", "speed": float, "steps": int, "solver": str,
       "stream": bool}
  GET  /health            503 until the model is warm, then 200; 503
                          {"status":"draining"} after SIGTERM/SIGINT
                          (graceful drain: in-flight work finishes,
                          bounded by DRAIN_TIMEOUT_S, default 30 s)

``"stream": true`` (beyond the reference) returns a chunked response:
the input is split into sentence segments that micro-batch together and
each segment's audio streams out as it completes (pcm or wav formats;
text cap STREAM_MAX_TEXT_LENGTH, default 5000 chars).

Config via env vars: CHECKPOINT_PATH, VOCODER_PATH, MAX_TEXT_LENGTH (1000),
PORT.  Differences from the reference: concurrent requests are micro-batched
into shared synthesis calls (serving/batcher.py) instead of being serialized.

The port's counterpart of ``matcha_tpu/serving/server.py``: the same HTTP
surface and service core, driving the PyTorch synthesizer.  Start it with
``python -m matcha_tpu_torch.serving.server``.

Implemented on stdlib http.server (threaded) so it runs with zero extra
dependencies; the handler core is framework-agnostic.
"""

from __future__ import annotations

import io
import json
import os
import re
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

SAMPLE_RATE = 24000
MAX_TEXT_LENGTH = int(os.environ.get("MAX_TEXT_LENGTH", "1000"))

_VOICE_MIX_RE = re.compile(r"^\s*(\d+)\s*\((\d+)\)\s*$")


def parse_voice(voice: str) -> list[tuple[int, float]]:
    """'2' → [(2, 1.0)]; '2(70)+6(30)' → [(2, .7), (6, .3)] (normalized).

    (reference: matcha/server.py:71-76)
    """
    voice = str(voice).strip()
    if "+" not in voice and "(" not in voice:
        return [(int(voice), 1.0)]
    parts = []
    for term in voice.split("+"):
        m = _VOICE_MIX_RE.match(term)
        if not m:
            raise ValueError(f"Bad voice spec {voice!r}")
        parts.append((int(m.group(1)), float(m.group(2))))
    total = sum(w for _, w in parts)
    if total <= 0:
        raise ValueError(f"Bad voice weights in {voice!r}")
    return [(i, w / total) for i, w in parts]


def wav_bytes(wav: np.ndarray, sample_rate: int = SAMPLE_RATE) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


class TTSService:
    """Framework-agnostic core shared by HTTP handlers and tests."""

    def __init__(self, synthesizer, use_batcher: bool = True):
        self.synth = synthesizer
        self.ready = False
        self.warming = True  # full ladder not yet compiled (health reports it)
        self.draining = False  # SIGTERM received: finish in-flight, refuse new
        # speech requests currently inside a handler thread (incl. response
        # encode/write, which outlives the batcher future) — begin_drain
        # waits for this to hit zero before stopping the serve loop, since
        # ThreadingHTTPServer's handler threads are daemons the process
        # exit would otherwise cut mid-write
        self._active_http = 0
        self._http_lock = threading.Lock()
        self.batcher = None
        # SERVE_FUSED (default ON, as in the JAX package): requests go
        # through the fused path, which skips the host round-trip between
        # the stages.  Rare bucket overflows fall back to the exact
        # two-stage pair; SERVE_FUSED=0 restores two-stage everywhere.
        self.fused = os.environ.get("SERVE_FUSED", "1") == "1"
        # DEFAULT_STEPS / DEFAULT_SOLVER: the operating point requests get
        # when they don't name one, AND the point warmup compiles — the
        # warmup-covers-serving invariant only holds for the default
        # (solver, steps); per-request overrides still work but compile
        # inline on first use.
        self.default_steps = int(os.environ.get("DEFAULT_STEPS", "4"))
        self.default_solver = os.environ.get("DEFAULT_SOLVER", "midpoint")
        if use_batcher:
            from matcha_tpu_torch.serving.batcher import RequestBatcher

            self.batcher = RequestBatcher(
                synthesizer,
                # default 16, the JAX package's serving point
                max_batch=int(os.environ.get("BATCHER_MAX_BATCH", "16")),
                max_wait_ms=float(os.environ.get("BATCHER_MAX_WAIT_MS", "15")),
                fused=self.fused,
                # SERVE_PIPELINE=N: keep up to N groups in flight so one
                # group's host work overlaps the next group's device work
                # (see batcher.py).  Default 4 as in the JAX package; not
                # measured on the card yet.  Set 1 for serial dispatch.
                pipeline=int(os.environ.get("SERVE_PIPELINE", "4")),
                n_timesteps=self.default_steps,
                solver=self.default_solver,
            )

    def warmup(self):
        # build the native library the Ogg/Opus encoder binds now, not inside
        # the first Ogg request; a failed build is remembered, and Ogg
        # requests then answer with its error
        from matcha_tpu_torch.utils import opus_converter

        opus_converter.available()
        # WARMUP_FULL=1 runs every reachable (text, mel) bucket pair once;
        # WARMUP_BATCH_SIZES (e.g. "1,2,4,8") the batcher's group ladder.
        sizes = tuple(
            int(s)
            for s in os.environ.get("WARMUP_BATCH_SIZES", "1").split(",")
        )
        full = os.environ.get("WARMUP_FULL", "0") == "1"
        # WARMUP_PROGRESSIVE=1: flip /health ready as soon as the FIRST
        # group size is warm and admit larger groups as theirs finish
        # (health reports "warming" until the whole ladder is done).
        if (
            os.environ.get("WARMUP_PROGRESSIVE", "0") == "1"
            and self.batcher is not None
        ):
            self.batcher.set_group_cap(1)

            def on_size_ready(b: int):
                self.batcher.set_group_cap(b)
                if not self.ready:
                    print(f"progressive warmup: serving (group cap {b})")
                self.ready = True

            self.synth.warmup(
                n_timesteps=self.default_steps,
                solver=self.default_solver,
                full=full,
                batch_sizes=sizes,
                fused=self.fused,
                on_size_ready=on_size_ready,
            )
            self.batcher.set_group_cap(None)
        else:
            self.synth.warmup(
                n_timesteps=self.default_steps,
                solver=self.default_solver,
                full=full,
                batch_sizes=sizes,
                fused=self.fused,
            )
        self.ready = True
        self.warming = False

    def _parse_common(self, body: dict, max_text: int = None) -> dict:
        """Validate/normalize the request fields shared by speak paths."""
        text = body.get("input", "")
        ids = body.get("phoneme_ids")  # pretokenized path: skips eSpeak
        if not text and not ids:
            raise ValueError("empty input")
        limit = MAX_TEXT_LENGTH if max_text is None else max_text
        if text and len(text) > limit:
            raise ValueError(f"input exceeds {limit} characters")
        if ids is not None:
            ids = [int(i) for i in ids]
            if not all(0 <= i < 600 for i in ids):
                raise ValueError("phoneme_ids out of range")
        speed = float(body.get("speed", 1.0))
        return {
            "text": text,
            "ids": ids,
            "voice_mix": parse_voice(body.get("voice", "0")),
            "length_scale": float(np.clip(1.0 / max(speed, 1e-3), 0.1, 2.0)),
            "steps": int(body.get("steps", self.default_steps)),
            "solver": body.get("solver", self.default_solver),
        }

    def speak(self, body: dict) -> tuple[bytes, str]:
        req = self._parse_common(body)
        text, ids = req["text"], req["ids"]
        voice_mix = req["voice_mix"]
        length_scale = req["length_scale"]
        steps, solver = req["steps"], req["solver"]
        fmt = body.get("response_format", "mp3")

        if ids is None:
            from matcha_tpu_torch.inference import voice_by_id
            from matcha_tpu_torch.text.phonemizers import (
                emphasize_intonation_marks,
                multilingual_phonemizer,
            )

            language = voice_by_id(voice_mix[0][0])["lang"]
            _, ids = multilingual_phonemizer(
                emphasize_intonation_marks(text), language
            )

        t0 = time.perf_counter()
        if self.batcher is not None:
            result = self.batcher.submit(
                ids,
                length_scale=length_scale,
                n_timesteps=steps,
                solver=solver,
                voice_mix=voice_mix,
            ).result(timeout=120)
        else:
            result = self.synth.synthesise_ids(
                ids,
                voice_mix=voice_mix,
                n_timesteps=steps,
                solver=solver,
                length_scale=length_scale,
                fused=self.fused,
            )
        elapsed = time.perf_counter() - t0
        audio_sec = len(result.wav) / SAMPLE_RATE
        print(f"synthesis: {elapsed*1000:.0f}ms for {audio_sec:.2f}s (RTF {elapsed/max(audio_sec,1e-9):.3f})")

        if fmt == "wav":
            return wav_bytes(result.wav), "audio/wav"
        if fmt == "pcm":
            return (np.clip(result.wav, -1, 1) * 32767).astype("<i2").tobytes(), (
                "audio/pcm"
            )
        if fmt in ("ogg", "opus", "ogg_opus"):
            from matcha_tpu_torch.utils.opus_converter import waveform_to_opus_ogg

            return waveform_to_opus_ogg(result.wav), "audio/ogg"
        from matcha_tpu_torch.utils.mp3_converter import waveform_to_mp3

        return waveform_to_mp3(result.wav), "audio/mpeg"

    def speak_stream(self, body: dict):
        """``"stream": true`` — segmented synthesis, chunked audio.

        Returns ``(chunk_iterator, content_type)``.  The input is split
        into sentence-aligned segments (serving/streaming.py) that are
        submitted to the micro-batcher together — they share padded
        synthesis calls, so total device work matches one big request — and each
        segment's PCM is yielded in order as soon as it is ready:
        time-to-first-audio is O(first segment), not O(text).

        Streamed formats: ``pcm`` (raw 16-bit LE) and ``wav`` (RIFF header
        with streaming 0xFFFFFFFF sizes, then the same PCM).  All request
        validation happens HERE, before the first chunk, so callers can
        still map ValueError to a 400; mid-stream failures surface as a
        truncated body (the HTTP status is already committed).

        Streaming raises the text cap to STREAM_MAX_TEXT_LENGTH (default
        5000) — long-form input is the point of the mode.
        """
        max_text = int(os.environ.get("STREAM_MAX_TEXT_LENGTH", "5000"))
        req = self._parse_common(body, max_text=max_text)
        voice_mix = req["voice_mix"]
        length_scale = req["length_scale"]
        steps, solver = req["steps"], req["solver"]
        fmt = body.get("response_format", "pcm")
        if fmt not in ("pcm", "wav"):
            raise ValueError(
                f"response_format {fmt!r} is not streamable (pcm or wav)"
            )

        from matcha_tpu_torch.serving.streaming import (
            split_ids,
            split_text,
            wav_stream_header,
        )

        # segment size knobs: larger = fewer/bigger chunks (better RTF),
        # smaller = lower time-to-first-audio.  Clamped so no segment can
        # exceed the synthesizer's largest text bucket (split_ids yields up
        # to 2*target+1 tokens): an oversize segment would otherwise raise
        # MID-stream, after the 200 is committed, truncating the body.
        largest = self.synth.text_buckets[-1]
        target_tokens = int(os.environ.get("STREAM_SEGMENT_TOKENS", "120"))
        target_tokens = min(target_tokens, max(1, (largest - 1) // 2))
        target_chars = int(os.environ.get("STREAM_SEGMENT_CHARS", "240"))
        if req["ids"] is not None:
            segments = split_ids(req["ids"], target=target_tokens)
        else:
            from matcha_tpu_torch.inference import voice_by_id
            from matcha_tpu_torch.text.phonemizers import (
                emphasize_intonation_marks,
                multilingual_phonemizer,
            )

            language = voice_by_id(voice_mix[0][0])["lang"]
            segments = []
            for seg in split_text(req["text"], max_chars=target_chars):
                ids = multilingual_phonemizer(
                    emphasize_intonation_marks(seg), language
                )[1]
                # char-based splitting has no token bound (each voiced
                # phoneme expands to a pre/P/post triple): re-split any
                # phonemized segment that would overflow the bucket ladder
                if len(ids) > largest:
                    segments.extend(split_ids(ids, target=target_tokens))
                elif ids:
                    # a symbol-only segment can phonemize to NOTHING — an
                    # empty utterance must never be submitted mid-stream
                    segments.append(ids)
        if not segments:
            raise ValueError("empty input")

        # submit BEFORE the caller commits the 200: a submission-time error
        # (e.g. the batcher wedge fail-fast) maps to a clean pre-commit 5xx
        # instead of an empty 200 body — and device work starts earlier
        futures = None
        if self.batcher is not None:
            futures = [
                self.batcher.submit(
                    seg,
                    length_scale=length_scale,
                    n_timesteps=steps,
                    solver=solver,
                    voice_mix=voice_mix,
                )
                for seg in segments
            ]

        def pcm(wav: np.ndarray) -> bytes:
            return (np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes()

        def chunks():
            t0 = time.perf_counter()
            if fmt == "wav":
                yield wav_stream_header()
            if futures is not None:
                results = (f.result(timeout=300) for f in futures)
            else:
                results = (
                    self.synth.synthesise_ids(
                        seg,
                        voice_mix=voice_mix,
                        n_timesteps=steps,
                        solver=solver,
                        length_scale=length_scale,
                        fused=self.fused,
                    )
                    for seg in segments
                )
            total_audio = 0.0
            first_chunk_ms = None
            for r in results:
                if first_chunk_ms is None:
                    first_chunk_ms = (time.perf_counter() - t0) * 1000
                total_audio += len(r.wav) / SAMPLE_RATE
                yield pcm(r.wav)
            elapsed = time.perf_counter() - t0
            print(
                f"stream: {len(segments)} segments, first chunk "
                f"{first_chunk_ms:.0f}ms, {elapsed*1000:.0f}ms total for "
                f"{total_audio:.2f}s (RTF {elapsed/max(total_audio,1e-9):.3f})"
            )

        return chunks(), ("audio/wav" if fmt == "wav" else "audio/pcm")


SPEECH_PATHS = {"/v1/audio/speech", "/audio/speech", "/v1/tts", "/tts"}


def make_handler(service: TTSService):
    class Handler(BaseHTTPRequestHandler):
        # chunked transfer framing is HTTP/1.1-only; the stdlib default of
        # HTTP/1.0 makes strict intermediaries (nginx with the default
        # proxy_http_version 1.0) deliver the chunk-size bytes as body.
        # Safe to declare 1.1 here: _send always sets Content-Length and
        # the stream path writes a proper 0-chunk terminator, so keep-alive
        # framing is always well-defined.
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quieter default logging
            pass

        def _send(self, code: int, body: bytes, ctype: str = "application/json"):
            try:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                # client hung up mid-response (short-timeout health probes
                # do this constantly during warmup) — not a server error;
                # don't let ThreadingHTTPServer print a full traceback
                self.close_connection = True

        def do_GET(self):
            if self.path == "/health":
                if service.draining:
                    # 503 pulls the pod from the load balancer while
                    # in-flight requests finish (graceful shutdown)
                    self._send(503, b'{"status":"draining"}')
                elif service.batcher is not None and service.batcher.wedged:
                    # flips the Docker HEALTHCHECK so the pod gets restarted
                    self._send(503, b'{"status":"wedged"}')
                elif service.ready:
                    # "warming": progressive warmup is serving at a reduced
                    # group cap while the rest of the ladder compiles
                    self._send(
                        200,
                        b'{"status":"ok","warming":true}'
                        if service.warming
                        else b'{"status":"ok"}',
                    )
                else:
                    self._send(503, b'{"status":"loading"}')
            else:
                self._send(404, b'{"error":"not found"}')

        def do_POST(self):
            if self.path not in SPEECH_PATHS:
                self._send(404, b'{"error":"not found"}')
                return
            if service.draining:
                self.close_connection = True
                self._send(503, b'{"error":"server draining"}')
                return
            if not service.ready:
                self._send(503, b'{"error":"model loading"}')
                return
            with service._http_lock:
                service._active_http += 1
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if body.get("stream"):
                    # validation happens before the first chunk, so errors
                    # here still map to a clean 400 below
                    chunks, ctype = service.speak_stream(body)
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    try:
                        for chunk in chunks:
                            if not chunk:
                                continue
                            self.wfile.write(b"%X\r\n" % len(chunk))
                            self.wfile.write(chunk)
                            self.wfile.write(b"\r\n")
                        self.wfile.write(b"0\r\n\r\n")
                    except Exception as exc:
                        # status already committed: a mid-stream failure
                        # surfaces to the client as a truncated body; the
                        # (keep-alive) connection carries no terminator so
                        # it must not be reused for another request
                        self.close_connection = True
                        print(f"stream aborted: {exc}")
                    return
                audio, ctype = service.speak(body)
                self._send(200, audio, ctype)
            except ValueError as exc:
                self._send(400, json.dumps({"error": str(exc)}).encode())
            except Exception as exc:  # pragma: no cover
                # log server-side BEFORE answering: the client may already
                # have timed out, and a BrokenPipe on the reply must not
                # swallow the actual failure
                import traceback

                traceback.print_exc()
                try:
                    self._send(500, json.dumps({"error": str(exc)}).encode())
                except OSError:
                    pass
            finally:
                with service._http_lock:
                    service._active_http -= 1

    return Handler


def main():
    ckpt = os.environ.get("CHECKPOINT_PATH")
    if not ckpt:
        raise SystemExit("Set CHECKPOINT_PATH to a checkpoint directory")
    import torch

    from matcha_tpu_torch.checkpoint import load_synthesizer
    from matcha_tpu_torch.inference import (
        DEFAULT_MEL_FINE_BUCKETS,
        DEFAULT_TEXT_BUCKETS,
    )

    # operational overrides: trim the bucket ladder for a known workload,
    # disable micro-batching for A/B latency measurement (USE_BATCHER=0),
    # SERVE_MESH=1 fans batched groups out over every card of the host (a
    # replica per card, each group's rows split between them)
    tb = os.environ.get("TEXT_BUCKETS")
    mb = os.environ.get("MEL_BUCKETS")
    mesh = None
    if os.environ.get("SERVE_MESH", "0") == "1" and torch.cuda.device_count() > 1:
        mesh = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        print(f"fan-out over {len(mesh)} cards")
    synth = load_synthesizer(
        ckpt,
        os.environ.get("VOCODER_PATH"),
        text_buckets=tuple(int(x) for x in tb.split(",")) if tb else DEFAULT_TEXT_BUCKETS,
        mel_fine_buckets=tuple(int(x) for x in mb.split(",")) if mb else DEFAULT_MEL_FINE_BUCKETS,
        mesh=mesh,
    )
    # FUSED_FRAMES_PER_TOKEN: the trained model's pace statistic (fine
    # frames per token at speed 1.0) behind the fused path's mel bucket
    fpt = os.environ.get("FUSED_FRAMES_PER_TOKEN")
    if fpt:
        synth.fused_frames_per_token = float(fpt)
    service = TTSService(
        synth, use_batcher=os.environ.get("USE_BATCHER", "1") == "1"
    )

    port = int(os.environ.get("PORT", "8000"))
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(service))
    threading.Thread(target=service.warmup, daemon=True).start()
    install_graceful_shutdown(service, server)
    print(f"serving on :{port} (warming up)")
    server.serve_forever()


def begin_drain(service, http_server, timeout_s: float = 30.0) -> bool:
    """Graceful shutdown: refuse new requests (health/speech 503), let
    in-flight synthesis finish, then stop the HTTP serve loop.

    Returns True when all accepted work completed within ``timeout_s``.
    The reference relies on uvicorn's connection draining; here the
    synthesis queue is explicit, so the drain waits for it too.
    """
    service.draining = True
    deadline = time.monotonic() + timeout_s
    done = True
    if service.batcher is not None:
        done = service.batcher.drain(timeout_s=timeout_s)
    # wait for handler threads to finish encoding/writing responses
    # (they are daemons — process exit would cut them mid-write); covers
    # serial-mode synthesis too, which runs inside the handler thread
    while time.monotonic() < deadline and getattr(service, "_active_http", 0):
        time.sleep(0.05)
    http_server.shutdown()
    return done and not getattr(service, "_active_http", 0)


def install_graceful_shutdown(service, http_server):
    import signal

    timeout_s = float(os.environ.get("DRAIN_TIMEOUT_S", "30"))

    def _term(signum, frame):
        print(f"signal {signum}: draining (timeout {timeout_s:.0f}s)")
        threading.Thread(
            target=begin_drain,
            args=(service, http_server, timeout_s),
            daemon=True,
        ).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)


if __name__ == "__main__":
    main()
