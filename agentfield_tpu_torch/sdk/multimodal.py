"""Typed multimodal content wrappers + response detection: the port's copy
of ``agentfield_tpu/sdk/multimodal.py`` (standard library only). The towers
and heads it routes to are the port's node's (``models/vision.py``,
``models/audio.py``, ``models/image_gen.py``).

API parity with the reference's multimodal helpers (sdk/python/agentfield/
multimodal.py: Text/Image/Audio/File content types, auto-detection of
multimodal arguments, response wrapping with save helpers —
agent_ai.py:449 `_process_multimodal_args`, multimodal_response.py).

IMAGE and AUDIO INPUT are served modalities: ``Agent.ai(images=[...])``
routes image parts to a vision-tower model node (models/vision.py — ViT
patch embeddings fused into the prompt) and ``Agent.ai(audio=[...])`` routes
audio parts to an audio-tower node (models/audio.py — log-mel frame
embeddings, same ``_fuse_media`` early-fusion path). AUDIO OUTPUT is served
by the TTS head (``ai(output="audio"|"speech")`` → WAV parts in the
response). FILE parts are served for text-like types: they inline into the
prompt as fenced blocks (``file_prompt_block``); binary files are rejected
with a reason naming the supported routes (reference file handling:
agent_ai.py:449-520).
"""

from __future__ import annotations

import base64
import dataclasses
import mimetypes
from pathlib import Path
from typing import Any


@dataclasses.dataclass(frozen=True)
class TextContent:
    text: str

    def to_part(self) -> dict[str, Any]:
        return {"type": "text", "text": self.text}


@dataclasses.dataclass(frozen=True)
class ImageContent:
    data: bytes
    mime: str = "image/png"

    @staticmethod
    def from_file(path: str | Path) -> "ImageContent":
        p = Path(path)
        mime = mimetypes.guess_type(str(p))[0] or "image/png"
        return ImageContent(p.read_bytes(), mime)

    def to_part(self) -> dict[str, Any]:
        return {
            "type": "image",
            "mime": self.mime,
            "data_b64": base64.b64encode(self.data).decode(),
        }


@dataclasses.dataclass(frozen=True)
class AudioContent:
    data: bytes
    mime: str = "audio/wav"

    @staticmethod
    def from_file(path: str | Path) -> "AudioContent":
        p = Path(path)
        mime = mimetypes.guess_type(str(p))[0] or "audio/wav"
        return AudioContent(p.read_bytes(), mime)

    def to_part(self) -> dict[str, Any]:
        return {
            "type": "audio",
            "mime": self.mime,
            "data_b64": base64.b64encode(self.data).decode(),
        }


@dataclasses.dataclass(frozen=True)
class FileContent:
    data: bytes
    name: str
    mime: str = "application/octet-stream"

    @staticmethod
    def from_file(path: str | Path) -> "FileContent":
        p = Path(path)
        mime = mimetypes.guess_type(str(p))[0] or "application/octet-stream"
        return FileContent(p.read_bytes(), name=p.name, mime=mime)

    def to_part(self) -> dict[str, Any]:
        return {
            "type": "file",
            "name": self.name,
            "mime": self.mime,
            "data_b64": base64.b64encode(self.data).decode(),
        }


Content = TextContent | ImageContent | AudioContent | FileContent


class UnsupportedModalityError(NotImplementedError):
    pass


def classify(arg: Any) -> Content:
    """Auto-detect content type the way the reference classifies ai() args
    (agent_ai.py:449): str → text; bytes sniffed by magic numbers; Content
    passes through."""
    if isinstance(arg, (TextContent, ImageContent, AudioContent, FileContent)):
        return arg
    if isinstance(arg, str):
        return TextContent(arg)
    if isinstance(arg, bytes):
        if arg[:8] == b"\x89PNG\r\n\x1a\n":
            return ImageContent(arg, "image/png")
        if arg[:3] == b"\xff\xd8\xff":
            return ImageContent(arg, "image/jpeg")
        if arg[:4] == b"RIFF" and arg[8:12] == b"WAVE":
            return AudioContent(arg, "audio/wav")
        return FileContent(arg, name="blob")
    raise TypeError(f"cannot classify {type(arg).__name__} as content")


_TEXTLIKE_MIMES = {
    "application/json", "application/xml", "application/x-yaml",
    "application/yaml", "application/toml", "application/csv",
    "application/javascript", "application/x-python", "application/x-sh",
    "application/sql",
}


def file_to_text(part: FileContent, max_bytes: int = 256_000) -> str:
    """Extract a file part's text for prompt inlining. Text-like mime types
    (text/*, json/xml/yaml/csv/source) and anything that cleanly decodes as
    NUL-free UTF-8 pass; binary files raise UnsupportedModalityError naming
    the supported routes. Oversized text truncates with a marker (the model
    node's context trimming governs the final budget anyway)."""
    textlike = part.mime.startswith("text/") or part.mime in _TEXTLIKE_MIMES
    data = part.data
    truncated = len(data) > max_bytes
    if truncated:
        data = data[:max_bytes]
        # back off a cut that landed mid-codepoint: a valid UTF-8 file must
        # not be misclassified as binary because of where we sliced it
        while data and (data[-1] & 0xC0) == 0x80:
            data = data[:-1]
        if data and data[-1] >= 0xC0:
            data = data[:-1]
    try:
        text = data.decode("utf-8")
    except UnicodeDecodeError:
        text = None
    if text is None and textlike:
        text = data.decode("utf-8", errors="replace")
    if text is not None and "\x00" in text:
        # NUL-laced "text" (UTF-16 dumps, binaries with text mimes) would
        # feed the model mojibake with no signal — reject loudly instead
        text = None
    if text is None:
        raise UnsupportedModalityError(
            f"file {part.name!r} ({part.mime}) is binary or not UTF-8: only "
            "UTF-8 text-like files inline into the prompt — send images via "
            "images=, audio via audio=; other formats are not a servable "
            "modality"
        )
    if truncated:
        text += "\n... [file truncated]"
    # a file whose CONTENT contains literal media markers must not change
    # the prompt's marker arithmetic (SDK and node both count them)
    return _break_markers(text)


def _break_markers(s: str) -> str:
    """Neutralize literal media markers (prompt arithmetic protection —
    zero-width space breaks the match without visibly altering text)."""
    return s.replace("<image>", "<image\u200b>").replace("<audio>", "<audio\u200b>")


def file_prompt_block(part: FileContent, max_bytes: int = 256_000) -> str:
    """One file part → the fenced prompt block the model sees. The header's
    name/mime get the same marker neutralization as the content — a filename
    containing a literal "<image>" must not corrupt the marker count."""
    return (
        f"--- file: {_break_markers(part.name)} ({_break_markers(part.mime)}) ---\n"
        f"{file_to_text(part, max_bytes)}\n--- end file ---"
    )


def to_text_prompt(parts: list[Content]) -> str:
    """Flatten content to a text prompt for text-only model nodes; non-text
    parts raise UnsupportedModalityError naming the roadmap item."""
    texts = []
    for p in parts:
        if isinstance(p, TextContent):
            texts.append(p.text)
        else:
            raise UnsupportedModalityError(
                f"{type(p).__name__} requires a multimodal model node "
                "(this call path flattens to text only)"
            )
    return "\n".join(texts)


def split_prompt_and_media(
    args: list[Any],
) -> tuple[str, list[dict[str, Any]], list[dict[str, Any]]]:
    """Classify mixed ai() args (reference `_process_multimodal_args`,
    agent_ai.py:449): text parts join into the prompt with an ``<image>`` /
    ``<audio>`` marker standing in for each media part at its argument
    position; media parts become the wire payloads the model node's towers
    consume. Text-like file parts inline as fenced blocks at their argument
    position; binary files raise UnsupportedModalityError."""
    pieces: list[str] = []
    images: list[dict[str, Any]] = []
    audios: list[dict[str, Any]] = []
    for arg in args:
        part = classify(arg)
        if isinstance(part, TextContent):
            pieces.append(part.text)
        elif isinstance(part, ImageContent):
            pieces.append("<image>")
            images.append({"b64": base64.b64encode(part.data).decode()})
        elif isinstance(part, AudioContent):
            pieces.append("<audio>")
            audios.append({"b64": base64.b64encode(part.data).decode()})
        else:
            # text-like files inline at their argument position; binary
            # raises UnsupportedModalityError with the reason
            pieces.append(file_prompt_block(part))
    return "\n".join(pieces), images, audios


def split_prompt_and_images(args: list[Any]) -> tuple[str, list[dict[str, Any]]]:
    """Image-only compatibility wrapper over split_prompt_and_media; audio
    parts here raise (the caller asked for an images-only split)."""
    prompt, images, audios = split_prompt_and_media(args)
    if audios:
        raise UnsupportedModalityError(
            "audio parts need split_prompt_and_media / ai(audio=[...])"
        )
    return prompt, images


# ---------------------------------------------------------------------------
# Response detection / wrapping (reference: multimodal_response.py —
# detect_multimodal_response wraps provider outputs carrying image/audio
# payloads so callers get typed objects with save helpers)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultimodalResponse:
    """A model result carrying non-text payloads alongside its text."""

    text: str
    parts: list[Content]
    raw: dict[str, Any]

    def save_all(self, directory: str | Path, stem: str = "output") -> list[Path]:
        """Write every binary part to ``directory`` (reference: the response
        wrappers' save helpers). Returns the written paths."""
        out = []
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        # stdlib mimetypes lacks audio/wav on some platforms (only x-wav)
        _EXT = {"audio/wav": ".wav", "audio/x-wav": ".wav"}
        for i, p in enumerate(self.parts):
            if isinstance(p, TextContent):
                continue
            ext = _EXT.get(p.mime) or mimetypes.guess_extension(p.mime) or ".bin"
            path = d / f"{stem}_{i}{ext}"
            path.write_bytes(p.data)
            out.append(path)
        return out


def detect_multimodal_response(result: dict[str, Any]) -> MultimodalResponse | dict[str, Any]:
    """Inspect a model-node result for binary output parts. Text-only results
    pass through unchanged; results with a ``parts`` list of typed content
    dicts (``{"type": "image"|"audio"|"file", "data_b64": ...}``) wrap into a
    MultimodalResponse with save helpers."""
    raw_parts = result.get("parts")
    if not isinstance(raw_parts, list) or not raw_parts:
        return result
    parts: list[Content] = []
    for rp in raw_parts:
        if not isinstance(rp, dict):
            return result  # not the typed-part shape; leave untouched
        kind = rp.get("type")
        if kind == "text":
            parts.append(TextContent(rp.get("text", "")))
            continue
        try:
            data = base64.b64decode(rp.get("data_b64", ""))
        except Exception:
            return result
        if kind == "image":
            parts.append(ImageContent(data, rp.get("mime", "image/png")))
        elif kind == "audio":
            parts.append(AudioContent(data, rp.get("mime", "audio/wav")))
        elif kind == "file":
            parts.append(FileContent(data, rp.get("name", "blob"), rp.get("mime", "application/octet-stream")))
        else:
            return result
    return MultimodalResponse(text=result.get("text", ""), parts=parts, raw=result)
