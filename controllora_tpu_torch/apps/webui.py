"""Zero-dependency web UI for the port's demo apps (counterpart of
``apps/_webui.py``).

The reference serves its demos through gradio (reference
apps/gradio_canny2image.py:104-121); gradio is installed on neither the CPU machine
nor the card's, so the apps serve this stdlib ``http.server`` UI. It drives the app's
``process()`` callback, the same resize -> annotate -> BGR-flip -> normalize -> CFG
sampling chain (reference apps:66-92). Images are decoded and encoded by the port's
own PNG codec (``utils/png.py``; the card's machine has no PIL): the uploaded image
must be a PNG (8-bit gray, RGB or RGBA; read as RGB, alpha dropped, as PIL's
``convert("RGB")`` does).

Surfaces:
  GET  /          HTML form (image upload + prompt + the app's DEFAULTS fields)
  POST /generate  multipart form -> HTML gallery of inline PNGs
  POST /api       JSON {"image": <base64 png>, "prompt": str, <fields>} ->
                  {"images": [<base64 png>, ...]} (programmatic/test surface)
"""

from __future__ import annotations

import base64
import html
import json
from email.parser import BytesParser
from email.policy import default as _email_policy
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from controllora_tpu_torch.utils.png import decode_png, encode_png


def _parse_multipart(content_type: str, body: bytes):
    """RFC 2046 multipart/form-data via the stdlib email parser (cgi is deprecated)."""
    msg = BytesParser(policy=_email_policy).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n" + body
    )
    out = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        payload = part.get_payload(decode=True)
        if name is None:
            continue
        out[name] = payload if part.get_filename() else payload.decode("utf-8")
    return out


def _coerce(fields: dict, defaults: dict) -> dict:
    """Cast submitted strings to the DEFAULTS field types (int/float/str)."""
    out = {}
    for k, v in defaults.items():
        raw = fields.get(k, v)
        out[k] = type(v)(raw) if not isinstance(raw, type(v)) else raw
    return out


def _form_html(title: str, defaults: dict, body_html: str = "") -> str:
    rows = []
    for k, v in defaults.items():
        if isinstance(v, str):
            inp = (f'<textarea name="{k}" rows="2" '
                   f'style="width:100%">{html.escape(v)}</textarea>')
        else:
            step = "1" if isinstance(v, int) else "0.1"
            inp = f'<input type="number" name="{k}" value="{v}" step="{step}">'
        rows.append(f"<label>{k}</label><br>{inp}<br>")
    return f"""<!doctype html><html><head><title>{html.escape(title)}</title></head>
<body style="font-family:sans-serif;max-width:760px;margin:2em auto">
<h2>{html.escape(title)}</h2>
<form method="post" action="/generate" enctype="multipart/form-data">
<label>input image</label><br><input type="file" name="image" required><br>
<label>prompt</label><br><textarea name="prompt" rows="2" style="width:100%"></textarea><br>
{''.join(rows)}
<button type="submit">Run</button>
</form>
{body_html}
</body></html>"""


def build_server(title: str, process, defaults: dict,
                 host: str = "0.0.0.0", port: int = 7860) -> ThreadingHTTPServer:
    """HTTP server wired to the app's `process(image, prompt, **defaults-fields)`."""

    def run_process(img: np.ndarray, prompt: str, fields: dict):
        outs = process(img, prompt, **fields)
        return [np.asarray(o, np.uint8) for o in outs]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; the apps print their own status
            pass

        def _send(self, code: int, ctype: str, payload: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path not in ("/", "/index.html"):
                self._send(404, "text/plain", b"not found")
                return
            self._send(200, "text/html; charset=utf-8",
                       _form_html(title, defaults).encode("utf-8"))

        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length", "0")))
            try:
                if self.path == "/api":
                    req = json.loads(body)
                    img = decode_png(base64.b64decode(req["image"]))
                    fields = _coerce(req, defaults)
                    outs = run_process(img, req.get("prompt", ""), fields)
                    payload = json.dumps({
                        "images": [base64.b64encode(encode_png(o)).decode("ascii")
                                   for o in outs]
                    }).encode("utf-8")
                    self._send(200, "application/json", payload)
                elif self.path == "/generate":
                    form = _parse_multipart(self.headers.get("Content-Type", ""), body)
                    img = decode_png(form["image"])
                    fields = _coerce(form, defaults)
                    outs = run_process(img, str(form.get("prompt", "")), fields)
                    gallery = "".join(
                        f'<img style="max-width:360px;margin:4px" '
                        f'src="data:image/png;base64,'
                        f'{base64.b64encode(encode_png(o)).decode("ascii")}">'
                        for o in outs
                    )
                    self._send(200, "text/html; charset=utf-8",
                               _form_html(title, defaults,
                                          f"<h3>Results</h3>{gallery}").encode("utf-8"))
                else:
                    self._send(404, "text/plain", b"not found")
            except Exception as e:  # surface errors to the client, keep serving
                self._send(500, "text/plain", f"error: {e}".encode("utf-8"))

    return ThreadingHTTPServer((host, port), Handler)


def serve_app(title: str, process, defaults: dict,
              host: str = "0.0.0.0", port: int = 7860) -> None:
    server = build_server(title, process, defaults, host, port)
    print(f"serving {title!r} at http://{host}:{server.server_address[1]}/ "
          "(stdlib web UI)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
