"""HTTP client for the serving stack — counterpart of the reference's
python/test_svr.py smoke client, usable as a library or CLI. A copy of
``whisper_tpu/serving/client.py``: it speaks to either package's server.

    python -m whisper_tpu_torch.serving.client --wav demo.wav --host 127.0.0.1 --port 8000
"""

from __future__ import annotations

import argparse
import json
import urllib.request


def transcribe_file(
    wav_path: str,
    host: str = "127.0.0.1",
    port: int = 8000,
    language: str = "zh",
    task: str = "transcribe",
    timeout: float = 300.0,
    use_multipart: bool = True,
    beam: int = 1,
    word_timestamps: bool = False,
    initial_prompt: str = "",
    condition_on_previous: bool = False,
    fmt: str = "json",
) -> dict:
    url = f"http://{host}:{port}/asr"
    if use_multipart:
        boundary = "whispertpuclient"
        with open(wav_path, "rb") as f:
            wav = f.read()
        extra = ""
        if initial_prompt:
            extra += (
                f"--{boundary}\r\n"
                'Content-Disposition: form-data; name="initial_prompt"\r\n\r\n'
                f"{initial_prompt}\r\n")
        if condition_on_previous:
            extra += (
                f"--{boundary}\r\n"
                'Content-Disposition: form-data; '
                'name="condition_on_previous"\r\n\r\n1\r\n')
        if fmt and fmt != "json":
            extra += (
                f"--{boundary}\r\n"
                'Content-Disposition: form-data; name="format"\r\n\r\n'
                f"{fmt}\r\n")
        body = (
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="language"\r\n\r\n'
            f"{language}\r\n"
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="task"\r\n\r\n'
            f"{task}\r\n"
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="beam"\r\n\r\n'
            f"{beam}\r\n"
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="word_timestamps"\r\n\r\n'
            f"{int(word_timestamps)}\r\n"
            f"{extra}"
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="wav"; filename="audio.wav"\r\n'
            "Content-Type: audio/wav\r\n\r\n"
        ).encode() + wav + f"\r\n--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            url, data=body,
            headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    else:
        from ..ops.audio import load_audio

        pcm = load_audio(wav_path).astype("<f4").tobytes()
        headers = {"Content-Type": "application/octet-stream",
                   "X-Language": language, "X-Task": task,
                   "X-Beam": str(beam),
                   "X-Word-Timestamps": str(int(word_timestamps))}
        if initial_prompt:
            headers["X-Initial-Prompt"] = (
                initial_prompt.encode("utf-8").decode("latin-1"))
        if condition_on_previous:
            headers["X-Condition-On-Previous"] = "1"
        if fmt and fmt != "json":
            headers["X-Format"] = fmt
        req = urllib.request.Request(url, data=pcm, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if fmt and fmt != "json":
            # rendered transcript (srt/vtt/tsv/txt): raw text, not JSON
            return {"success": True, "format": fmt,
                    "text": r.read().decode("utf-8")}
        return json.load(r)


def health(host: str = "127.0.0.1", port: int = 8000, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(f"http://{host}:{port}/health", timeout=timeout) as r:
        return json.load(r)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("whisper_tpu_torch.serving.client")
    p.add_argument("--wav", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--language", "-l", default="zh")
    p.add_argument("--task", default="transcribe")
    p.add_argument("--pcm", action="store_true", help="use the raw-PCM protocol")
    p.add_argument("--beam", type=int, default=1,
                   help="beam size (1 = greedy slots; >1 = beam worker)")
    p.add_argument("--word_timestamps", action="store_true",
                   help="request per-word timings")
    p.add_argument("--initial_prompt", default="",
                   help="OpenAI-style free-text context (vocabulary/style priming)")
    p.add_argument("--condition_on_previous", action="store_true",
                   help=">30 s requests decode windows sequentially, each "
                        "conditioned on the accumulated transcript")
    p.add_argument("--format", dest="fmt", default="json",
                   choices=["json", "txt", "srt", "vtt", "tsv"],
                   help="response rendering")
    args = p.parse_args(argv)
    res = transcribe_file(args.wav, args.host, args.port, args.language,
                          args.task, use_multipart=not args.pcm,
                          beam=args.beam,
                          word_timestamps=args.word_timestamps,
                          initial_prompt=args.initial_prompt,
                          condition_on_previous=args.condition_on_previous,
                          fmt=args.fmt)
    if args.fmt != "json":
        print(res["text"], end="")
    else:
        print(json.dumps(res, ensure_ascii=False, indent=2))
    return 0 if res.get("success") else 1


if __name__ == "__main__":
    raise SystemExit(main())
