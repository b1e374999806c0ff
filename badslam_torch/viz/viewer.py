"""Standalone WebGL map viewer: a one-shot HTML export and a live view with
run controls.

Counterpart of ``badslam_tpu/viz/viewer.py`` (the reference's render
window and GUI controls, render_window.h, gui_main_window.cc):

  * one-shot (`export_html_viewer`): the map exported once into a single
    self-contained HTML file: shaded surfel splats (size from the radius,
    shading from the normal), the trajectory, keyframe frustums with
    click-to-inspect panels (RGB and colormapped depth), orbit and zoom,
    no external assets.
  * live (`LiveViewer`): the same HTML shell in polling mode, a map
    snapshot (``map_data.json``, written atomically) every N keyframes and
    a local HTTP server over the directory. Its /control endpoint pauses,
    steps and resumes the frame loop and queues commands (manual BA,
    densify, runtime config edits, keyframe move and delete) that the
    front end applies on its own thread.

The HTML shell is the JAX package's, unchanged. Panels are PNGs written by
``io/png.py`` with the Turbo colormap (`_TURBO_RGB`), so no OpenCV is
needed. A snapshot reads device state (`.cpu()`), a synchronization: keep
the live interval coarse and never take snapshots while timing.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import threading

import numpy as np

from badslam_torch.geometry import se3_np as s3
from badslam_torch.io.png import encode_png

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>badslam_tpu map</title>
<style>
 body { margin:0; background:#111; color:#ccc; font:12px monospace; overflow:hidden }
 #hud { position:absolute; top:8px; left:8px; z-index:2; user-select:none }
 #pick { position:absolute; bottom:8px; left:8px; z-index:2; color:#fb3 }
 #ims { position:absolute; top:8px; right:8px; z-index:2; text-align:right }
 #ims img { display:block; margin-bottom:4px; border:1px solid #444;
            max-width:240px }
 button { background:#222; color:#ccc; border:1px solid #555; margin-right:4px;
          font:12px monospace; cursor:pointer }
 canvas { display:block }
</style></head>
<body>
<div id="hud">badslam_tpu viewer — drag: orbit · wheel: zoom · shift-drag: pan · click: pick keyframe<br>
 points: <span id="np"></span> · keyframes: <span id="nk"></span> · frames: <span id="nf"></span> <span id="live"></span><br>
 <span id="ctl" style="display:none">
  <button onclick="control('pause')">pause</button>
  <button onclick="control('step')">step</button>
  <button onclick="control('resume')">run</button>
  <button onclick="control('ba')">BA</button>
  <button onclick="control('densify')">densify</button>
  <span id="state"></span>
 </span>
 <button onclick="toggleConfig()">config</button>
 <button onclick="screenshot()">screenshot</button>
 <button onclick="pathAdd()" title="add camera keypoint">path+</button>
 <button onclick="pathPlay()" title="fly a Catmull-Rom spline through the keypoints">play</button>
 <button onclick="pathClear()">clear</button>
 <span id="pathinfo"></span>
 <div id="cfgedit" style="display:none; background:#181818; padding:6px;
      border:1px solid #a60; margin-top:4px"></div>
 <pre id="cfg" style="display:none; max-height:70vh; overflow:auto;
      background:#181818; padding:6px; border:1px solid #444"></pre></div>
<div id="pick" style="white-space:pre"></div>
<div id="kfpanel" style="display:none; position:absolute; bottom:8px; right:8px;
     z-index:2; text-align:right">
 <img id="kfrgb" style="display:block; margin-bottom:4px; border:1px solid #a60">
 <img id="kfdepth" style="display:block; border:1px solid #a60">
 <div id="kftools" style="margin-top:4px">
  <!-- debug/fault-injection tools (gui_main_window.h:143,234 analogs):
       manually move the picked keyframe or delete it outright -->
  <button onclick="kfNudge(0.02,0,0)">+x</button>
  <button onclick="kfNudge(-0.02,0,0)">-x</button>
  <button onclick="kfNudge(0,0.02,0)">+y</button>
  <button onclick="kfNudge(0,-0.02,0)">-y</button>
  <button onclick="kfNudge(0,0,0.02)">+z</button>
  <button onclick="kfNudge(0,0,-0.02)">-z</button>
  <button onclick="kfDelete()" style="color:#f66">delete KF</button>
 </div>
</div>
<div id="ims"></div>
<canvas id="c"></canvas>
<script>
const POLL_MS = __POLL_MS__;
function decode(b64, dtype) {
  const raw = atob(b64); const buf = new ArrayBuffer(raw.length);
  const view = new Uint8Array(buf);
  for (let i = 0; i < raw.length; i++) view[i] = raw.charCodeAt(i);
  return dtype === 'u8' ? new Uint8Array(buf) : new Float32Array(buf);
}

const canvas = document.getElementById('c');
const gl = canvas.getContext('webgl');
// Splat shader: point size from the surfel radius projected to pixels,
// circular mask + normal shading in the fragment (render_window.cc splat
// rendering analog).
const VS = `attribute vec3 p; attribute vec3 c; attribute vec3 n; attribute float r;
 uniform mat4 mvp; uniform float focalpx; uniform float ps; varying vec3 vc; varying vec3 vn;
 void main(){
   gl_Position = mvp*vec4(p,1.0);
   float z = max(gl_Position.w, 1e-3);
   gl_PointSize = (ps > 0.0) ? ps : clamp(2.0 * r * focalpx / z, 1.5, 24.0);
   vc = c; vn = n; }`;
const FS = `precision mediump float; varying vec3 vc; varying vec3 vn;
 uniform float splat;
 void main(){
   if (splat > 0.5) {
     vec2 d = gl_PointCoord - vec2(0.5);
     if (dot(d, d) > 0.25) discard;
     float shade = 0.55 + 0.45 * abs(vn.z);
     gl_FragColor = vec4(vc * shade, 1.0);
   } else { gl_FragColor = vec4(vc, 1.0); } }`;
function shader(type, src){ const s = gl.createShader(type);
 gl.shaderSource(s, src); gl.compileShader(s); return s; }
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const locP = gl.getAttribLocation(prog, 'p');
const locC = gl.getAttribLocation(prog, 'c');
const locN = gl.getAttribLocation(prog, 'n');
const locR = gl.getAttribLocation(prog, 'r');
const locM = gl.getUniformLocation(prog, 'mvp');
const locS = gl.getUniformLocation(prog, 'ps');
const locF = gl.getUniformLocation(prog, 'focalpx');
const locSplat = gl.getUniformLocation(prog, 'splat');

function makeBuf(arr){ const b = gl.createBuffer();
 gl.bindBuffer(gl.ARRAY_BUFFER, b);
 gl.bufferData(gl.ARRAY_BUFFER, arr, gl.DYNAMIC_DRAW); return b; }

let posBuf=null, colBuf=null, nrmBuf=null, radBuf=null, trajBuf=null, kfBuf=null;
let nPos=0, nTraj=0, nKf=0;
let kfPos=null, kfIds=null, kfPoses=null, kfPanels=null, picked=-1;
let cx=0, cy=0, cz=0, haveCenter=false;

function setData(DATA){
  const pos = decode(DATA.pos, 'f32'), col = decode(DATA.col, 'u8');
  const nrm = decode(DATA.nrm, 'f32'), rad = decode(DATA.rad, 'f32');
  const traj = decode(DATA.traj, 'f32'), kf = decode(DATA.kf, 'f32');
  kfPos = decode(DATA.kf_pos, 'f32');
  kfIds = JSON.parse(atob(DATA.kf_ids));
  kfPoses = DATA.kf_poses || null;
  kfPanels = DATA.kf_panels || null;
  document.getElementById('np').textContent = pos.length / 3;
  document.getElementById('nk').textContent = DATA.kf_count;
  document.getElementById('nf').textContent = traj.length / 3;
  const colF = new Float32Array(col.length);
  for (let i = 0; i < col.length; i++) colF[i] = col[i] / 255.0;
  posBuf = makeBuf(pos); colBuf = makeBuf(colF);
  nrmBuf = makeBuf(nrm); radBuf = makeBuf(rad);
  trajBuf = makeBuf(traj); kfBuf = makeBuf(kf);
  nPos = pos.length/3; nTraj = traj.length/3; nKf = kf.length/3;
  if (!haveCenter && nPos > 0){
    cx=0; cy=0; cz=0;
    for (let i=0;i<pos.length;i+=3){cx+=pos[i];cy+=pos[i+1];cz+=pos[i+2];}
    cx/=nPos; cy/=nPos; cz/=nPos; haveCenter = true;
  }
  // Current-frame image panels (ImageDisplay analog, image_display.h).
  const ims = document.getElementById('ims');
  ims.innerHTML = '';
  if (DATA.rgb_png){
    const im = document.createElement('img');
    im.src = 'data:image/png;base64,' + DATA.rgb_png; ims.appendChild(im);
  }
  if (DATA.depth_png){
    const im = document.createElement('img');
    im.src = 'data:image/png;base64,' + DATA.depth_png; ims.appendChild(im);
  }
}

let yaw=0.6, pitch=0.4, dist=4.0, panX=0, panY=0;
let drag=null, moved=false;
canvas.onmousedown = e => { drag = {x:e.clientX, y:e.clientY, shift:e.shiftKey}; moved=false; };
window.onmouseup = e => {
  if (drag && !moved) pick(e.clientX, e.clientY);
  drag = null; };
window.onmousemove = e => { if(!drag) return;
 const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
 if (Math.abs(dx)+Math.abs(dy) > 2) moved=true;
 if (drag.shift){ panX -= dx*0.002*dist; panY += dy*0.002*dist; }
 else { yaw += dx*0.005; pitch += dy*0.005; }
 drag.x=e.clientX; drag.y=e.clientY; };
canvas.onwheel = e => { dist *= Math.exp(e.deltaY*0.001); e.preventDefault(); };

let lastM = null;
function pick(mx, my){
  if (!kfPos || !lastM) return;
  const w = canvas.width, h = canvas.height;
  let best = -1, bestD = 18*18;
  for (let k = 0; k < kfPos.length/3; k++){
    const x = kfPos[3*k], y = kfPos[3*k+1], z = kfPos[3*k+2];
    const cw = lastM[3]*x + lastM[7]*y + lastM[11]*z + lastM[15];
    if (cw <= 0) continue;
    const sx = (lastM[0]*x + lastM[4]*y + lastM[8]*z + lastM[12]) / cw;
    const sy = (lastM[1]*x + lastM[5]*y + lastM[9]*z + lastM[13]) / cw;
    const px = (sx * 0.5 + 0.5) * w, py = (-sy * 0.5 + 0.5) * h;
    const d = (px-mx)*(px-mx) + (py-my)*(py-my);
    if (d < bestD){ bestD = d; best = k; }
  }
  picked = best;
  // Keyframe inspection dialog (gui_keyframe_dialog.cc analog): slot,
  // dataset frame, pose, and the keyframe's RGB/colormapped-depth panels.
  const el = document.getElementById('pick');
  const kfp = document.getElementById('kfpanel');
  if (best < 0){ el.textContent = ''; kfp.style.display = 'none'; return; }
  let txt = 'keyframe slot ' + kfIds[best][0] + ' · dataset frame ' + kfIds[best][1];
  if (kfPoses && kfPoses[best]){
    const p = kfPoses[best];
    txt += '\\n t = [' + p.slice(4).map(v => v.toFixed(4)).join(', ') + ']'
         + '\\n q = [' + p.slice(0, 4).map(v => v.toFixed(5)).join(', ') + ']';
  }
  el.textContent = txt;
  const slot = String(kfIds[best][0]);
  if (kfPanels && kfPanels[slot]){
    document.getElementById('kfrgb').src = 'data:image/png;base64,' + kfPanels[slot][0];
    document.getElementById('kfdepth').src = 'data:image/png;base64,' + kfPanels[slot][1];
    kfp.style.display = 'block';
  } else kfp.style.display = 'none';
}

function mat(){
 const w = canvas.width = innerWidth, h = canvas.height = innerHeight;
 gl.viewport(0,0,w,h);
 const f = 1.5, a = w/h, near=0.01, far=1000;
 const P = [f/a,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1,
            0,0,2*far*near/(near-far),0];
 const cp=Math.cos(pitch), sp=Math.sin(pitch), cyw=Math.cos(yaw), syw=Math.sin(yaw);
 const ex = cx + dist*cp*syw + panX, ey = cy + dist*sp + panY, ez = cz + dist*cp*cyw;
 // lookAt
 let zx=ex-cx-panX, zy=ey-cy-panY, zz=ez-cz; const zl=Math.hypot(zx,zy,zz);
 zx/=zl; zy/=zl; zz/=zl;
 let xx=zz, xy2=0, xz=-zx; const xl=Math.hypot(xx,xy2,xz)||1; xx/=xl; xz/=xl;
 const yx=zy*xz, yy=zz*xx-zx*xz, yz=-zy*xx;
 const V = [xx,yx,zx,0, xy2,yy,zy,0, xz,yz,zz,0,
   -(xx*ex+xy2*ey+xz*ez), -(yx*ex+yy*ey+yz*ez), -(zx*ex+zy*ey+zz*ez), 1];
 // P*V
 const M = new Float32Array(16);
 for (let r=0;r<4;r++) for (let c2=0;c2<4;c2++){ let s=0;
   for(let k=0;k<4;k++) s += P[k*4+r]*V[c2*4+k]; M[c2*4+r]=s; }
 lastM = M;
 gl.uniform1f(locF, 0.5 * h * f);
 return M;
}

function draw(buf, colbuf, mode, count, size, color, splat, nrmbuf, radbuf, first){
 if (!buf || count === 0) return;
 gl.bindBuffer(gl.ARRAY_BUFFER, buf);
 gl.enableVertexAttribArray(locP);
 gl.vertexAttribPointer(locP, 3, gl.FLOAT, false, 0, 0);
 if (colbuf){ gl.bindBuffer(gl.ARRAY_BUFFER, colbuf);
   gl.enableVertexAttribArray(locC);
   gl.vertexAttribPointer(locC, 3, gl.FLOAT, false, 0, 0); }
 else { gl.disableVertexAttribArray(locC);
   gl.vertexAttrib3f(locC, color[0], color[1], color[2]); }
 if (nrmbuf){ gl.bindBuffer(gl.ARRAY_BUFFER, nrmbuf);
   gl.enableVertexAttribArray(locN);
   gl.vertexAttribPointer(locN, 3, gl.FLOAT, false, 0, 0); }
 else { gl.disableVertexAttribArray(locN); gl.vertexAttrib3f(locN, 0, 0, 1); }
 if (radbuf){ gl.bindBuffer(gl.ARRAY_BUFFER, radbuf);
   gl.enableVertexAttribArray(locR);
   gl.vertexAttribPointer(locR, 1, gl.FLOAT, false, 0, 0); }
 else { gl.disableVertexAttribArray(locR); gl.vertexAttrib1f(locR, 0); }
 gl.uniform1f(locS, size);
 gl.uniform1f(locSplat, splat ? 1.0 : 0.0);
 gl.drawArrays(mode, first || 0, count);
}

function frame(){
 pathStep();
 const M = mat();
 gl.clearColor(0.07,0.07,0.09,1); gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
 gl.uniformMatrix4fv(locM, false, M);
 draw(posBuf, colBuf, gl.POINTS, nPos, 0.0, null, true, nrmBuf, radBuf);
 draw(trajBuf, null, gl.LINE_STRIP, nTraj, 1.0, [0.2,0.9,0.3], false);
 draw(kfBuf, null, gl.LINES, nKf, 1.0, [0.95,0.6,0.1], false);
 if (picked >= 0 && nKf >= (picked+1)*16)
   // each frustum contributes 16 contiguous line vertices
   draw(kfBuf, null, gl.LINES, 16, 1.0, [1.0,0.2,0.2], false, null, null,
        picked*16);
 requestAnimationFrame(frame);
}

// Fields the SLAM thread accepts as live edits (settings-window analog;
// must match BadSlam.RUNTIME_CONFIG_FIELDS).
const EDITABLE = ['fps_restriction', 'target_frame_rate',
  'keyframe_interval', 'max_num_ba_iterations_per_keyframe', 'parallel_ba',
  'do_surfel_updates', 'steady_frame_chunking', 'min_free_gpu_memory_mb'];

function renderConfigEdit(cfgObj){
  // Live runs get editable forms for the runtime-tunable subset
  // (gui_settings_window parameter forms); applied via /control on the
  // SLAM thread.
  const ed = document.getElementById('cfgedit');
  ed.innerHTML = '<b>runtime settings</b><br>';
  for (const k of EDITABLE){
    if (!(k in cfgObj)) continue;
    const row = document.createElement('div');
    const lbl = document.createElement('span');
    lbl.textContent = k + ' ';
    const inp = document.createElement('input');
    inp.value = String(cfgObj[k]);
    inp.size = 8;
    inp.style.cssText = 'background:#222;color:#ccc;border:1px solid #555';
    inp.onchange = () =>
      control('set:' + encodeURIComponent(k + '=' + inp.value));
    row.appendChild(lbl); row.appendChild(inp); ed.appendChild(row);
  }
  ed.style.display = 'block';
}

async function toggleConfig(){
  // Settings view (gui_settings_window analog): full config shown
  // verbatim; in live mode the runtime-tunable subset is editable.
  const el = document.getElementById('cfg');
  const ed = document.getElementById('cfgedit');
  if (el.style.display === 'none'){
    let cfgObj = typeof CONFIG !== 'undefined' && CONFIG ? CONFIG : null;
    if (!cfgObj){
      try {
        const r = await fetch('config.json', {cache: 'no-store'});
        cfgObj = await r.json();
      } catch (e) {}
    }
    el.textContent = cfgObj ? JSON.stringify(cfgObj, null, 1)
                            : 'config.json unavailable';
    if (cfgObj && POLL_MS > 0) renderConfigEdit(cfgObj);
    el.style.display = 'block';
  } else { el.style.display = 'none'; ed.style.display = 'none'; }
}
const CONFIG = __CONFIG__;

// ---- spline camera paths (render_window.cc + spline_library analog) ----
let pathKeys = [], pathT = -1;
function pathAdd(){
  pathKeys.push([yaw, pitch, dist, panX, panY]);
  document.getElementById('pathinfo').textContent =
    ' path: ' + pathKeys.length + ' keypoints';
}
function pathClear(){ pathKeys = []; pathT = -1;
  document.getElementById('pathinfo').textContent = ''; }
function pathPlay(){ if (pathKeys.length >= 2) pathT = 0; }
function catmull(p0, p1, p2, p3, t){
  const t2 = t*t, t3 = t2*t;
  return 0.5*((2*p1) + (-p0+p2)*t + (2*p0-5*p1+4*p2-p3)*t2
              + (-p0+3*p1-3*p2+p3)*t3);
}
function pathStep(){
  // Advance the camera along the Catmull-Rom spline (~3 s per segment
  // at 60 fps); clamped end tangents like centripetal spline players.
  if (pathT < 0 || pathKeys.length < 2) return;
  const nSeg = pathKeys.length - 1;
  if (pathT >= nSeg){ pathT = -1; return; }
  const seg = Math.floor(pathT), t = pathT - seg;
  const K = pathKeys;
  const p0 = K[Math.max(seg-1, 0)], p1 = K[seg],
        p2 = K[seg+1], p3 = K[Math.min(seg+2, nSeg)];
  const v = [];
  for (let i = 0; i < 5; i++) v.push(catmull(p0[i], p1[i], p2[i], p3[i], t));
  [yaw, pitch, dist, panX, panY] = v;
  pathT += 1.0 / 180.0;
}

function screenshot(){
  // Save-screenshot analog (gui_main_window.cc screenshot action): render
  // one frame synchronously, then download the canvas as PNG.
  const M = mat();
  gl.clearColor(0.07,0.07,0.09,1); gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(locM, false, M);
  draw(posBuf, colBuf, gl.POINTS, nPos, 0.0, null, true, nrmBuf, radBuf);
  draw(trajBuf, null, gl.LINE_STRIP, nTraj, 1.0, [0.2,0.9,0.3], false);
  draw(kfBuf, null, gl.LINES, nKf, 1.0, [0.95,0.6,0.1], false);
  const a = document.createElement('a');
  a.download = 'badslam_tpu_map.png';
  a.href = canvas.toDataURL('image/png');
  a.click();
}

async function control(cmd){
  try {
    const r = await fetch('control?cmd=' + cmd, {cache: 'no-store'});
    document.getElementById('state').textContent = await r.text();
  } catch (e) {}
}

// Debug/fault-injection tools on the picked keyframe (the reference GUI's
// manual frame move + keyframe delete, gui_main_window.h:143,234).
function kfNudge(dx, dy, dz){
  if (picked < 0 || !kfIds) return;
  control('move_kf:' + kfIds[picked][0] + ':' + dx + ',' + dy + ',' + dz);
}
function kfDelete(){
  if (picked < 0 || !kfIds) return;
  control('delete_kf:' + kfIds[picked][0]);
  picked = -1;
  document.getElementById('kfpanel').style.display = 'none';
}

const INLINE = __DATA__;
if (INLINE) setData(INLINE);
if (POLL_MS > 0){
  document.getElementById('ctl').style.display = 'inline';
  let gen = -1;
  async function poll(){
    try {
      const r = await fetch('map_data.json', {cache: 'no-store'});
      const d = await r.json();
      if (d.generation !== gen){ gen = d.generation; setData(d);
        document.getElementById('live').textContent = ' · live #' + gen; }
    } catch (e) {}
    setTimeout(poll, POLL_MS);
  }
  poll();
}
frame();
</script></body></html>
"""


# Google's Turbo colormap as 8-bit sRGB (its published 256-entry byte
# table), which is OpenCV's COLORMAP_TURBO: row v is the color of level v.
_TURBO_RGB = np.frombuffer(bytes.fromhex(
    "30123b32154333184a341b51351e5836215f37246638276d392a733a2d793b2f803c3286"
    "3d358b3e38913f3b973f3e9c4040a24143a74146ac4249b1424bb5434eba4451bf4454c3"
    "4456c74559cb455ccf455ed34661d64664da4666dd4669e0466be3476ee64771e94773eb"
    "4776ee4778f0477bf2467df44680f64682f84685fa4687fb458afc458cfd448ffe4391fe"
    "4294ff4196ff4099ff3e9bfe3d9efe3ba0fd3aa3fc38a5fb37a8fa35abf833adf731aff5"
    "2fb2f42eb4f22cb7f02ab9ee28bceb27bee925c0e723c3e422c5e220c7df1fc9dd1ecbda"
    "1ccdd81bd0d51ad2d21ad4d019d5cd18d7ca18d9c818dbc518ddc218dec018e0bd19e2bb"
    "19e3b91ae4b61ce6b41de7b21fe9af20eaac22ebaa25eca727eea42aefa12cf09e2ff19b"
    "32f29835f39438f4913cf58e3ff68a43f78746f8844af8804ef97d52fa7a55fa7659fb73"
    "5dfc6f61fc6c65fd6969fd666dfe6271fe5f75fe5c79fe597dff5680ff5384ff5188ff4e"
    "8bff4b8fff4992ff4796fe4499fe429cfe409ffd3fa1fd3da4fc3ca7fc3aa9fb39acfb38"
    "affa37b1f936b4f836b7f735b9f635bcf534bef434c1f334c3f134c6f034c8ef34cbed34"
    "cdec34d0ea34d2e935d4e735d7e535d9e436dbe236dde037dfdf37e1dd37e3db38e5d938"
    "e7d739e9d539ebd339ecd13aeecf3aefcd3af1cb3af2c93af4c73af5c53af6c33af7c13a"
    "f8be39f9bc39faba39fbb838fbb637fcb336fcb136fdae35fdac34fea933fea732fea431"
    "fea130fe9e2ffe9b2dfe992cfe962bfe932afe9029fd8d27fd8a26fc8725fc8423fb8122"
    "fb7e21fa7b1ff9781ef9751df8721cf76f1af66c19f56918f46617f36315f26014f15d13"
    "f05b12ef5811ed5510ec530feb500eea4e0de84b0ce7490ce5470be4450ae2430ae14109"
    "df3f08dd3d08dc3b07da3907d83706d63506d43305d23105d02f05ce2d04cc2b04ca2a04"
    "c82803c52603c32503c12302be2102bc2002b91e02b71d02b41b01b21a01af1801ac1701"
    "a91601a71401a41301a112019e10019b0f01980e01950d01920b018e0a018b0902880802"
    "8507028106027e05027a0403"), np.uint8).reshape(256, 3)


def _turbo_png(d: np.ndarray) -> bytes:
    """A depth image as a Turbo-colored PNG, scaled to its own maximum."""
    dmax = float(d.max()) or 1.0
    d8 = np.clip(255.0 * d / dmax, 0, 255).astype(np.uint8)
    return encode_png(_TURBO_RGB[d8])


def _b64_png(img: np.ndarray) -> str:
    return base64.b64encode(encode_png(img)).decode()


def _frustum_lines(q, t, cam, scale=0.08):
    """[16, 3] line-list vertices of one keyframe frustum."""
    corners = []
    for px, py in ((0, 0), (cam.width, 0), (cam.width, cam.height),
                   (0, cam.height)):
        nx = (px - cam.cx) / cam.fx
        ny = (py - cam.cy) / cam.fy
        corners.append(np.array([nx * scale, ny * scale, scale]))
    origin = np.zeros(3)
    pose = s3.SE3(np.asarray(q, float), np.asarray(t, float))
    pts = [s3.transform_points(pose, np.stack([origin, c])) for c in corners]
    lines = []
    for p in pts:
        lines.extend([p[0], p[1]])
    ring = [s3.transform_points(pose, c[None])[0] for c in corners]
    for i in range(4):
        lines.extend([ring[i], ring[(i + 1) % 4]])
    return np.stack(lines)


def _snapshot_dict(slam, max_points: int = 400_000, generation: int = 0) -> dict:
    """Map, trajectory and keyframe frustums as a JSON-able dict of base64
    buffers. Reads device state: the colors are refreshed (K2) and every
    tensor is copied to the host."""
    pos, nrm, col = slam.direct_ba.export_point_cloud()
    m = slam.direct_ba.surfels
    rad = np.sqrt(np.maximum(m.radius2.cpu().numpy()[m.valid.cpu().numpy()], 0.0))
    if len(pos) > max_points:
        # The JAX package's subsample: the same state gives the same points.
        sel = np.random.default_rng(0).choice(len(pos), max_points, replace=False)
        pos, nrm, col, rad = pos[sel], nrm[sel], col[sel], rad[sel]

    has = slam.has_pose
    traj = (slam.traj_t.cpu().numpy()[has].astype(np.float32) if has.any()
            else np.zeros((0, 3)))

    ks = slam.direct_ba.keyframes
    kf_lines, kf_pos, kf_ids, kf_poses = [], [], [], []
    kf_panels = {}
    q_np = ks.q.cpu().numpy()
    t_np = ks.t.cpu().numpy()
    valid = ks.valid.cpu().numpy()
    # Per-keyframe inspection panels: downscaled RGB and colormapped depth
    # from the keyframe planes, one batched read per snapshot.
    if ks.count > 0:
        rgb_all = ks.rgb[:ks.count].cpu().numpy()
        depth_all = ks.depth[:ks.count].cpu().numpy()
    for i in range(ks.count):
        if not valid[i]:
            continue
        kf_lines.append(_frustum_lines(q_np[i], t_np[i], slam.cam))
        kf_pos.append(t_np[i])
        kf_ids.append([int(i), int(ks.frame_indices[i])])
        kf_poses.append([float(v) for v in q_np[i]] + [float(v) for v in t_np[i]])
        if len(kf_panels) < 64:
            step = max(1, rgb_all.shape[2] // 160)
            kf_panels[str(i)] = [
                _b64_png(rgb_all[i, ::step, ::step]),
                base64.b64encode(_turbo_png(depth_all[i, ::step, ::step])).decode()]
    kf = (np.concatenate(kf_lines) if kf_lines else np.zeros((0, 3))).astype(np.float32)
    kf_pos = (np.stack(kf_pos) if kf_pos else np.zeros((0, 3))).astype(np.float32)

    def b64(arr, dtype):
        return base64.b64encode(np.ascontiguousarray(arr, dtype).tobytes()).decode()

    # Current-frame RGB and colormapped-depth panels from the host video
    # (none once a live frame has been released).
    rgb_png = depth_png = None
    idx = slam.last_frame_index
    if idx >= 0:
        rgb = np.asarray(slam.video.color_u8(idx))
        depth = np.asarray(slam.video.depth_u16(idx))
        if rgb.size and depth.size:
            step = max(1, rgb.shape[1] // 320)
            rgb_png = _b64_png(np.ascontiguousarray(rgb[::step, ::step]))
            depth_png = base64.b64encode(
                _turbo_png(depth[::step, ::step].astype(np.float32))).decode()

    return dict(
        rgb_png=rgb_png,
        depth_png=depth_png,
        pos=b64(pos, np.float32),
        col=b64(np.clip(col, 0, 255), np.uint8),
        nrm=b64(nrm, np.float32),
        rad=b64(rad, np.float32),
        traj=b64(traj, np.float32),
        kf=b64(kf, np.float32),
        kf_pos=b64(kf_pos, np.float32),
        kf_ids=base64.b64encode(json.dumps(kf_ids).encode()).decode(),
        kf_count=len(kf_ids),
        kf_poses=kf_poses,
        kf_panels=kf_panels,
        generation=generation,
    )


def export_html_viewer(slam, path: str, max_points: int = 400_000) -> None:
    """Write a self-contained HTML viewer of the current map and trajectory
    (end of run: reads the whole device state, like every export)."""
    data = _snapshot_dict(slam, max_points)
    cfg = json.dumps(dataclasses.asdict(slam.config))
    with open(path, "w") as f:
        f.write(_HTML.replace("__DATA__", json.dumps(data))
                     .replace("__POLL_MS__", "0")
                     .replace("__CONFIG__", cfg))


class LiveViewer:
    """Quasi-live map view: periodic snapshots and a local HTTP server.

    The front end calls `on_keyframe` after each keyframe; every
    `interval`-th writes ``directory/map_data.json``, which the polling
    HTML shell (``directory/index.html``) reloads. Run/Pause/Step drive the
    frame loop through /control (the front end calls `wait_if_paused`
    before each frame), and the command buttons queue work that the front
    end applies on its own thread. Every snapshot is a device read and a
    synchronization."""

    def __init__(self, directory: str, port: int = 0, interval: int = 5,
                 max_points: int = 400_000, poll_ms: int = 2000):
        self.directory = directory
        self.interval = max(1, interval)
        self.max_points = max_points
        self.generation = 0
        self.paused = False
        self._step = threading.Event()
        self._release_frame = False
        self._commands = []
        self._cmd_lock = threading.Lock()
        self._keyframes_seen = 0
        self._server = None
        self.port = None
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "index.html"), "w") as f:
            f.write(_HTML.replace("__DATA__", "null")
                         .replace("__POLL_MS__", str(poll_ms))
                         .replace("__CONFIG__", "null"))
        if port is not None:
            self._start_server(port)

    def _start_server(self, port: int) -> None:
        import http.server
        from functools import partial
        from urllib.parse import unquote

        viewer = self

        class _Handler(http.server.SimpleHTTPRequestHandler):
            def log_message(self, *args):  # no per-request output
                pass

            def do_GET(self):
                if self.path.startswith("/control"):
                    body = viewer.control(unquote(self.path.split("cmd=")[-1])).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                super().do_GET()

        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), partial(_Handler, directory=self.directory))
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    # -- run / pause / step ---------------------------------------------

    def control(self, cmd: str) -> str:
        if cmd == "pause":
            self.paused = True
        elif cmd == "resume":
            self.paused = False
            self._step.set()
        elif cmd == "step":
            self.paused = True
            self._release_frame = True
            self._step.set()
        elif (cmd in ("ba", "densify") or cmd.startswith("set:")
              or cmd.startswith("move_kf:") or cmd.startswith("delete_kf:")):
            # Manual BA and densify, runtime config edits and the keyframe
            # move / delete tools: queued here, applied by the frame loop
            # on the SLAM thread (never on the HTTP thread).
            with self._cmd_lock:
                self._commands.append(cmd)
            self._step.set()  # wake a paused loop so the command runs
        return "paused" if self.paused else "running"

    def take_commands(self):
        """Drain the queued commands (the front end applies them)."""
        with self._cmd_lock:
            cmds, self._commands = self._commands, []
        return cmds

    def wait_if_paused(self, on_wake=None) -> None:
        """Called by the frame loop before each frame: blocks while paused;
        a step releases exactly one frame. `on_wake` (the front end's
        command applier) runs whenever the loop wakes, so queued commands
        run on the SLAM thread even while paused."""
        if on_wake is not None:
            on_wake()
        while self.paused:
            if self._step.wait(timeout=0.05):
                self._step.clear()
                if on_wake is not None:
                    on_wake()
                if self._release_frame or not self.paused:
                    self._release_frame = False
                    return

    # -- snapshots ------------------------------------------------------

    def on_keyframe(self, slam) -> None:
        """Front-end hook: a snapshot every `interval`-th keyframe."""
        self._keyframes_seen += 1
        if self._keyframes_seen % self.interval == 0:
            self.snapshot(slam)

    def snapshot(self, slam) -> None:
        """Write map_data.json atomically (a temporary file, then rename)."""
        cfgp = os.path.join(self.directory, "config.json")
        if not os.path.exists(cfgp):
            with open(cfgp, "w") as f:
                json.dump(dataclasses.asdict(slam.config), f, indent=1)
        self.generation += 1
        data = _snapshot_dict(slam, self.max_points, self.generation)
        path = os.path.join(self.directory, "map_data.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
