"""Browser UI (a copy of ``genie_tts_tpu/server/webui.py``): operator
surface parity with the reference's PySide6 GUI (TTS tab with preset
manager, model/reference pickers, synthesis + playback; converter tab;
log tab).

On headless GPU hosts a desktop GUI is impractical; instead the HTTP
server serves this single-page UI at ``GET /``: character loading,
reference-audio registration, preset save/load (JSON persistence, role of
``GUI/PresetManager.py``), synthesis with in-browser playback of the
streamed PCM16 audio, and a live metrics pane.
"""
from __future__ import annotations

import json
from pathlib import Path

PRESETS_PATH = Path("genie_presets.json")


def load_presets() -> dict:
    if PRESETS_PATH.exists():
        try:
            return json.loads(PRESETS_PATH.read_text(encoding="utf-8"))
        except (OSError, json.JSONDecodeError):
            return {}
    return {}


def save_preset(name: str, preset: dict) -> None:
    presets = load_presets()
    presets[name] = preset
    PRESETS_PATH.write_text(json.dumps(presets, ensure_ascii=False, indent=2),
                            encoding="utf-8")


def delete_preset(name: str) -> None:
    presets = load_presets()
    presets.pop(name, None)
    PRESETS_PATH.write_text(json.dumps(presets, ensure_ascii=False, indent=2),
                            encoding="utf-8")


INDEX_HTML = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<title>genie-tts-tpu-torch</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:760px;margin:2rem auto;padding:0 1rem;background:#111;color:#ddd}
 h1{font-size:1.3rem} fieldset{border:1px solid #333;margin:1rem 0;padding:1rem}
 legend{color:#8cf} label{display:block;margin:.4rem 0 .1rem;font-size:.85rem;color:#aaa}
 input,textarea,select{width:100%;box-sizing:border-box;background:#1c1c1c;color:#eee;border:1px solid #444;padding:.4rem}
 button{background:#2a6;border:0;color:#fff;padding:.5rem 1rem;margin:.5rem .5rem 0 0;cursor:pointer}
 button.alt{background:#369} pre{background:#1a1a1a;padding:.6rem;overflow:auto;font-size:.75rem}
</style></head><body>
<h1>genie-tts-tpu-torch</h1>

<fieldset><legend>Presets</legend>
 <select id="preset"></select>
 <button class="alt" onclick="applyPreset()">Apply</button>
 <button class="alt" onclick="savePreset()">Save current as…</button>
 <button onclick="deletePreset()" style="background:#a33">Delete</button>
</fieldset>

<fieldset><legend>Character</legend>
 <label>Name</label><input id="cname" value="my_voice">
 <label>Checkpoint directory</label><input id="cdir" placeholder="/path/to/converted/character">
 <label>Language</label>
 <select id="clang"><option>ja</option><option>en</option><option>zh</option><option>hybrid</option></select>
 <button onclick="loadChar()">Load character</button>
</fieldset>

<fieldset><legend>Reference audio</legend>
 <label>Audio path (server-side)</label><input id="rpath" placeholder="/path/to/ref.wav">
 <label>Transcript</label><input id="rtext">
 <button onclick="setRef()">Set reference</button>
</fieldset>

<fieldset><legend>Synthesize</legend>
 <label>Text</label><textarea id="text" rows="4"></textarea>
 <label><input type="checkbox" id="split" checked style="width:auto"> split sentences</label>
 <button onclick="speak()">Synthesize &amp; play</button>
 <button onclick="stopTTS()" style="background:#a33">Stop</button>
 <audio id="player" controls style="width:100%;margin-top:.6rem"></audio>
</fieldset>

<fieldset><legend>Convert checkpoints</legend>
 <label>.ckpt path (or leave empty and give a folder)</label><input id="vckpt">
 <label>.pth path</label><input id="vpth">
 <label>Folder (picks the epoch-max .ckpt/.pth)</label><input id="vfolder">
 <label>Output character directory</label><input id="vout">
 <label>Language</label>
 <select id="vlang"><option>ja</option><option>en</option><option>zh</option></select>
 <button onclick="startConvert()">Convert</button>
 <button class="alt" onclick="refreshJobs()">Refresh jobs</button>
 <pre id="jobs"></pre>
</fieldset>

<fieldset><legend>Server logs</legend>
 <button class="alt" onclick="refreshLogs()">Refresh</button>
 <pre id="srvlogs" style="max-height:16rem"></pre>
</fieldset>

<fieldset><legend>Status</legend><pre id="log"></pre></fieldset>

<script>
const log = m => { const el = document.getElementById('log');
  el.textContent = (new Date().toLocaleTimeString()) + '  ' + m + '\\n' + el.textContent; };
async function post(path, body) {
  const r = await fetch(path, {method:'POST', headers:{'Content-Type':'application/json'},
                               body: JSON.stringify(body)});
  if (!r.ok) { const e = await r.json().catch(()=>({detail:r.statusText}));
               throw new Error(e.detail || r.statusText); }
  return r; }
function vals(){ return {character_name: cname.value, model_dir: cdir.value,
  language: clang.value, audio_path: rpath.value, audio_text: rtext.value,
  text: text.value}; }
async function loadChar(){ try { await post('/load_character', vals()); log('character loaded'); }
  catch(e){ log('ERROR '+e.message); } }
async function setRef(){ try { await post('/set_reference_audio', vals()); log('reference set'); }
  catch(e){ log('ERROR '+e.message); } }
async function stopTTS(){ await post('/stop', {}); log('stopped'); }
async function speak(){
  try {
    log('synthesizing…');
    const r = await post('/tts', {character_name: cname.value, text: text.value,
                                  split_sentence: split.checked});
    const pcm = new Int16Array(await r.arrayBuffer());
    const ctx = new AudioContext({sampleRate: 32000});
    const buf = ctx.createBuffer(1, pcm.length, 32000);
    const ch = buf.getChannelData(0);
    for (let i = 0; i < pcm.length; i++) ch[i] = pcm[i] / 32768;
    const wav = encodeWav(ch);
    player.src = URL.createObjectURL(new Blob([wav], {type:'audio/wav'}));
    player.play();
    log('done: ' + (pcm.length/32000).toFixed(2) + ' s');
  } catch(e){ log('ERROR '+e.message); } }
function encodeWav(f32){
  const n = f32.length, b = new ArrayBuffer(44 + n*2), v = new DataView(b);
  const w = (o,s)=>{for(let i=0;i<s.length;i++)v.setUint8(o+i,s.charCodeAt(i));};
  w(0,'RIFF'); v.setUint32(4,36+n*2,true); w(8,'WAVEfmt '); v.setUint32(16,16,true);
  v.setUint16(20,1,true); v.setUint16(22,1,true); v.setUint32(24,32000,true);
  v.setUint32(28,64000,true); v.setUint16(32,2,true); v.setUint16(34,16,true);
  w(36,'data'); v.setUint32(40,n*2,true);
  for(let i=0;i<n;i++) v.setInt16(44+i*2, Math.max(-1,Math.min(1,f32[i]))*32767, true);
  return b; }
async function refreshPresets(){
  const r = await fetch('/presets'); const p = await r.json();
  preset.innerHTML = Object.keys(p).map(k=>`<option>${k}</option>`).join(''); }
async function applyPreset(){
  const r = await fetch('/presets'); const p = (await r.json())[preset.value];
  if (!p) return; cname.value=p.character_name||''; cdir.value=p.model_dir||'';
  clang.value=p.language||'ja'; rpath.value=p.audio_path||''; rtext.value=p.audio_text||'';
  log('preset applied: '+preset.value); }
async function savePreset(){
  const name = prompt('Preset name'); if (!name) return;
  await post('/presets', {name, preset: vals()}); await refreshPresets();
  log('preset saved: '+name); }
async function deletePreset(){
  await post('/presets/delete', {name: preset.value}); await refreshPresets(); }
async function startConvert(){
  try {
    const body = {out: vout.value, language: vlang.value};
    if (vckpt.value && vpth.value) { body.ckpt = vckpt.value; body.pth = vpth.value; }
    else body.folder = vfolder.value;
    const r = await post('/convert', body); const j = await r.json();
    log('conversion started: ' + j.job_id);
    setTimeout(refreshJobs, 1000);
  } catch(e){ log('ERROR '+e.message); } }
async function refreshJobs(){
  const r = await fetch('/convert_jobs'); const j = await r.json();
  jobs.textContent = Object.entries(j).map(([k,v]) =>
    `${k}: ${v.state}${v.version ? ' ('+v.version+')' : ''}${v.error ? ' — '+v.error : ''}`).join('\\n'); }
async function refreshLogs(){
  const r = await fetch('/logs'); const j = await r.json();
  srvlogs.textContent = j.lines.slice(-80).reverse().join('\\n'); }
refreshPresets();
</script></body></html>
"""
