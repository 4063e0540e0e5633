"""HTTP streaming server: a copy of ``genie_tts_tpu/server/http.py`` on
the port's API. POST ``/load_character``, ``/set_reference_audio``,
``/tts`` (chunked PCM16 stream), ``/unload_character``, ``/stop``,
``/clear_reference_audio_cache``, ``/convert``, ``/presets``; GET
``/health``, ``/metrics``, ``/logs``, ``/convert_jobs``, ``/presets`` and
the web UI at ``/``. ``/set_reference_audio`` with ``"warmup": true``
also runs the character's warmup sweep (``api.warmup_character``).

Implemented on the stdlib (ThreadingHTTPServer + chunked transfer
encoding, one thread per request); a FastAPI app factory is provided
where FastAPI is installed. Characters and reference clips go to the
device given to :func:`start_server` (cuda unless named).
"""
from __future__ import annotations

import json
import logging
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

logger = logging.getLogger(__name__)

# the device characters and reference clips are loaded onto (None: cuda)
_device = None


def _sampling_from_payload(payload: dict):
    """Optional per-request sampling overrides (top_k/top_p/temperature/
    repetition_penalty). Requests carrying any of these still join the
    slot machine — sampling parameters are per-row state there, not
    compiled graph constants (ops/sampling.py::SamplingRows)."""
    keys = ("top_k", "top_p", "temperature", "repetition_penalty")
    if not any(k in payload for k in keys):
        return None
    from ..ops.sampling import SamplingConfig

    base = SamplingConfig()
    return SamplingConfig(**{k: type(getattr(base, k))(payload[k])
                             for k in keys if k in payload})


def _synthesize_stream(payload: dict, chunk_q: "queue.Queue") -> None:
    """Run a TTS session in this (worker) thread, pushing PCM16 chunks."""
    from .. import api

    character = payload["character_name"]
    text = payload["text"]
    split = bool(payload.get("split_sentence", True))
    sampling = _sampling_from_payload(payload)
    if character not in api._reference_audios:
        chunk_q.put(RuntimeError("set_reference_audio has not been called"))
        chunk_q.put(None)
        return
    try:
        from ..runtime.session import session_registry

        # default serving path: concurrent requests' sentences batch on the
        # card (the slot machine, or the window batcher for sentences that
        # do not fit it). "stream": true selects the streaming routes.
        want_stream = bool(payload.get("stream", False))
        batching = api.engine.cfg.serve_batching and not want_stream
        synth, synth_stream = api._make_synth_fn(character, sampling=sampling,
                                                 use_batcher=batching)
        if batching:
            synth_stream = None  # sentence-granular chunks via the batcher
        session = session_registry.create()  # per-request isolation
        emitted = 0

        def cb(c):
            nonlocal emitted
            if c is None:
                return  # stream termination pushed below
            emitted += 1
            chunk_q.put(c)

        session.start_session(
            synth, play=False, split=split, chunk_callback=cb,
            synth_stream_fn=synth_stream)
        session.feed(text)
        session.end_session()
        session.wait_for_tts_completion()
        if emitted == 0 and session.first_error is not None:
            # the whole session failed: report instead of an empty 200
            chunk_q.put(session.first_error)
        chunk_q.put(None)
    except Exception as e:  # surfaced as HTTP 500 by the handler
        logger.exception("tts stream failed")
        chunk_q.put(e)
        chunk_q.put(None)


# conversion jobs (the reference GUI's converter tab runs these on a
# QThread; here a background thread + a status dict polled by the UI)
_convert_jobs: dict = {}
_convert_seq = 0
_convert_lock = threading.Lock()


def _start_convert_job(payload: dict) -> dict:
    """Start a background conversion. Payload: ``out`` + either
    ``ckpt``+``pth`` or ``folder`` (epoch-max pick, GUI behavior)."""
    global _convert_seq
    from ..convert.torch_convert import convert_character, find_checkpoints

    ckpt, pth = payload.get("ckpt"), payload.get("pth")
    if not (ckpt and pth):
        folder = payload.get("folder")
        if not folder:
            raise ValueError("convert needs ckpt+pth or a folder")
        ckpt, pth = find_checkpoints(folder)
        if not (ckpt and pth):
            raise ValueError(f"no .ckpt/.pth found in {folder}")
    out = payload["out"]
    language = payload.get("language", "Japanese")
    with _convert_lock:
        _convert_seq += 1
        job_id = f"job{_convert_seq}"
    _convert_jobs[job_id] = {"state": "running",
                             "ckpt": str(ckpt), "pth": str(pth), "out": out}

    def run():
        try:
            version = convert_character(ckpt, pth, out, language=language,
                                        version=payload.get("version"))
            _convert_jobs[job_id].update(state="done", version=version)
        except Exception as e:  # job status carries the failure
            logger.exception("conversion failed")
            _convert_jobs[job_id].update(state="failed", error=str(e))

    threading.Thread(target=run, daemon=True, name=f"convert-{job_id}").start()
    return {"job_id": job_id}


class GenieHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "genie-tts-tpu-torch"

    def log_message(self, fmt, *args):  # route through logging
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _json_body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def _reply(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.path == "/metrics":
            from ..utils.metrics import metrics

            return self._reply(200, metrics.snapshot())
        if self.path == "/logs":
            from ..utils import logs

            return self._reply(200, {"lines": logs.snapshot()})
        if self.path == "/convert_jobs":
            return self._reply(200, dict(_convert_jobs))
        if self.path == "/health":
            return self._reply(200, {"status": "ok"})
        if self.path in ("/", "/index.html"):
            from .webui import INDEX_HTML

            body = INDEX_HTML.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path == "/presets":
            from .webui import load_presets

            return self._reply(200, load_presets())
        return self._reply(404, {"detail": f"unknown endpoint {self.path}"})

    def do_POST(self):  # noqa: N802 (stdlib API)
        from .. import api

        try:
            payload = self._json_body()
        except (ValueError, json.JSONDecodeError):
            return self._reply(400, {"detail": "invalid JSON body"})
        try:
            if self.path == "/load_character":
                api.load_character(payload["character_name"],
                                   payload["onnx_model_dir"]
                                   if "onnx_model_dir" in payload
                                   else payload["model_dir"],
                                   payload["language"], device=_device)
                return self._reply(200, {"status": "ok"})
            if self.path == "/set_reference_audio":
                ok = api.set_reference_audio(payload["character_name"],
                                             payload["audio_path"],
                                             payload["audio_text"],
                                             payload.get("language"),
                                             device=_device)
                if not ok:
                    return self._reply(400, {"detail": "unsupported audio format"})
                if payload.get("warmup"):
                    api.warmup_character(payload["character_name"])
                return self._reply(200, {"status": "ok"})
            if self.path == "/unload_character":
                api.unload_character(payload["character_name"])
                return self._reply(200, {"status": "ok"})
            if self.path == "/stop":
                api.stop()
                return self._reply(200, {"status": "ok"})
            if self.path == "/clear_reference_audio_cache":
                api.clear_reference_audio_cache()
                return self._reply(200, {"status": "ok"})
            if self.path == "/tts":
                return self._handle_tts(payload)
            if self.path == "/convert":
                return self._reply(200, _start_convert_job(payload))
            if self.path == "/presets":
                from .webui import save_preset

                save_preset(payload["name"], payload["preset"])
                return self._reply(200, {"status": "ok"})
            if self.path == "/presets/delete":
                from .webui import delete_preset

                delete_preset(payload["name"])
                return self._reply(200, {"status": "ok"})
            return self._reply(404, {"detail": f"unknown endpoint {self.path}"})
        except (KeyError, ValueError, FileNotFoundError) as e:
            return self._reply(400, {"detail": str(e)})
        except Exception as e:
            logger.exception("request failed")
            return self._reply(500, {"detail": str(e)})

    def _handle_tts(self, payload: dict) -> None:
        chunk_q: "queue.Queue" = queue.Queue()
        worker = threading.Thread(
            target=_synthesize_stream, args=(payload, chunk_q), daemon=True)
        worker.start()

        first = chunk_q.get()
        if isinstance(first, Exception):
            chunk_q.get()  # consume the trailing None
            # client errors (unreadable text, bad inputs) -> 400;
            # engine failures -> 500
            code = 400 if isinstance(
                first, (ValueError, KeyError, FileNotFoundError)) else 500
            return self._reply(code, {"detail": str(first)})

        from .. import api

        char = api.model_manager.get(payload["character_name"])
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        if char is not None:
            # the PCM16 stream's rate: 32000, or 48000 for a V4 character
            self.send_header("X-Sample-Rate", str(char.sample_rate))
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def send_chunk(data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

        item = first
        while item is not None:
            if isinstance(item, Exception):
                break
            if item:
                send_chunk(item)
            item = chunk_q.get()
        self.wfile.write(b"0\r\n\r\n")


_server: Optional[ThreadingHTTPServer] = None


def start_server(host: str = "127.0.0.1", port: int = 8000,
                 workers: int = 1, block: bool = True,
                 device=None) -> ThreadingHTTPServer:
    """Serve the TTS API; returns the server (port 0 binds a free port:
    read it from ``server.server_address``).

    ``device``: where loaded characters and reference clips go (cuda
    unless named; with no GPU and no device named, loading raises).
    ``workers`` is accepted for reference-API compatibility: one process
    serves many concurrent requests (thread per request, batched onto the
    card), and N processes sharing one card would only contend; several
    cards serve from this one process through ``GENIE_MESH="DPxTP"``
    (``api._serving_mesh``). A warning is logged when workers > 1.
    """
    if workers > 1:
        logger.warning(
            "workers=%d ignored: requests batch onto the card in one process; "
            "set GENIE_MESH=DPxTP to serve over several cards", workers)
    global _server, _device
    from ..utils import logs

    _device = device
    logs.install()  # ring buffer behind GET /logs (GUI log-tab parity)
    server = ThreadingHTTPServer((host, port), GenieHandler)
    _server = server
    logger.info("genie-tts-tpu-torch server listening on %s:%d", host,
                server.server_address[1])
    if block:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def stop_server() -> None:
    global _server
    if _server is not None:
        _server.shutdown()
        _server = None


def create_fastapi_app():
    """FastAPI app with identical endpoints (when FastAPI is installed)."""
    try:
        from fastapi import FastAPI
        from fastapi.responses import StreamingResponse
    except ImportError as e:
        raise ImportError(
            "create_fastapi_app needs the 'fastapi' package, which is not "
            "installed; start_server() serves the same endpoints on the "
            "standard library") from e

    from .. import api

    app = FastAPI(title="genie-tts-tpu-torch")

    @app.post("/load_character")
    def load_character(payload: dict):
        api.load_character(payload["character_name"], payload["model_dir"],
                           payload["language"], device=_device)
        return {"status": "ok"}

    @app.post("/set_reference_audio")
    def set_reference_audio(payload: dict):
        api.set_reference_audio(payload["character_name"], payload["audio_path"],
                                payload["audio_text"], payload.get("language"),
                                device=_device)
        if payload.get("warmup"):
            api.warmup_character(payload["character_name"])
        return {"status": "ok"}

    @app.post("/unload_character")
    def unload_character(payload: dict):
        api.unload_character(payload["character_name"])
        return {"status": "ok"}

    @app.post("/stop")
    def stop():
        api.stop()
        return {"status": "ok"}

    @app.post("/clear_reference_audio_cache")
    def clear_cache():
        api.clear_reference_audio_cache()
        return {"status": "ok"}

    @app.post("/tts")
    async def tts(payload: dict):
        gen = api.tts_async(payload["character_name"], payload["text"],
                            split_sentence=payload.get("split_sentence", True))
        return StreamingResponse(gen, media_type="audio/wav")

    return app
