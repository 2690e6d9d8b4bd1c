// Native batch Karel execution engine.
//
// Executes the same (op, arg) bytecode emitted by
// demo2program_tpu/dsl/karel_bytecode.py — one compiler, three executors
// (host Python interpreter, on-device VM, this engine), all property-tested
// equivalent. Role: the hot host-side rollout loop of dataset generation
// (reference: karel_env/generator.py's per-demo Python interpreter runs),
// where Python-level stepping dominates. The engine runs a batch of
// rollouts in one call and returns full state/action traces.
//
// Budget semantics (MAX_FUNC_CALL = 100) are encoded in the bytecode via
// BUDGET/INC instructions; see dsl/karel_interp.py for the transcription
// from the reference karel_env/dsl/dsl_parse.py.
//
// Build: g++ -O3 -shared -fPIC -o libkarel.so karel_engine.cpp

#include <cstdint>
#include <cstring>

namespace {

constexpr int OP_HALT = 0;
constexpr int OP_BUDGET = 1;
constexpr int OP_INC = 2;
constexpr int OP_ACT = 3;
constexpr int OP_EVAL = 4;
constexpr int OP_NEGC = 5;
constexpr int OP_JMP = 6;
constexpr int OP_JMPF = 7;
constexpr int OP_PUSHCTR = 8;
constexpr int OP_JZDEC = 9;

constexpr int MAX_FUNC_CALL = 100;
constexpr int MAX_LOOP_DEPTH = 8;
constexpr int MAX_MARKER_CAP = 9;  // reference karel.py:174 put cap

// facing: 0 N, 1 E, 2 S, 3 W
constexpr int DY_FRONT[4] = {-1, 0, 1, 0};
constexpr int DX_FRONT[4] = {0, 1, 0, -1};
constexpr int DY_LEFT[4] = {0, -1, 0, 1};
constexpr int DX_LEFT[4] = {-1, 0, 1, 0};
constexpr int DY_RIGHT[4] = {0, 1, 0, -1};
constexpr int DX_RIGHT[4] = {1, 0, -1, 0};

struct Rollout {
    const int32_t* code;   // (code_len, 2)
    int code_len;
    const uint8_t* wall;   // (h, w)
    int8_t* markers;       // (h, w) mutable working copy
    int y, x, d;
    int h, w;
    bool make_error;
};

inline bool clear_at(const Rollout& r, int ny, int nx) {
    if (ny < 0 || ny >= r.h || nx < 0 || nx >= r.w) return false;
    return !r.wall[ny * r.w + nx];
}

}  // namespace

extern "C" {

// Runs n_rollouts rollouts; rollout i executes program prog_idx[i].
//
// inputs:
//   bytecode       (n_progs, code_len, 2) int32
//   walls          (n_rollouts, h, w)  uint8 (0/1)
//   markers0       (n_rollouts, h, w)  int8 marker counts
//   agent0         (n_rollouts, 3)     int32 (y, x, d)
// outputs (caller-allocated):
//   out_success    (n_rollouts,)  uint8
//   out_len        (n_rollouts,)  int32  state-history length incl. initial
//                                 (counts past max_record without storing)
//   out_n          (n_rollouts,)  int32  final budget counter
//   out_actions    (n_rollouts, max_record-1) int8
//   out_agent      (n_rollouts, max_record, 3) int32
//   out_markers    (n_rollouts, max_record, h, w) int8
int karel_run_batch(const int32_t* bytecode, int n_progs, int code_len,
                    const uint8_t* walls, const int8_t* markers0,
                    const int32_t* agent0, const int32_t* prog_idx,
                    int n_rollouts, int h, int w, int make_error,
                    int max_record,
                    uint8_t* out_success, int32_t* out_len, int32_t* out_n,
                    int8_t* out_actions, int32_t* out_agent,
                    int8_t* out_markers) {
    const int cells = h * w;
    int8_t* work = new int8_t[cells];

    for (int i = 0; i < n_rollouts; ++i) {
        const int p = prog_idx[i];
        if (p < 0 || p >= n_progs) { delete[] work; return -1; }
        std::memcpy(work, markers0 + (size_t)i * cells, cells);

        Rollout r;
        r.code = bytecode + (size_t)p * code_len * 2;
        r.code_len = code_len;
        r.wall = walls + (size_t)i * cells;
        r.markers = work;
        r.y = agent0[i * 3 + 0];
        r.x = agent0[i * 3 + 1];
        r.d = agent0[i * 3 + 2];
        r.h = h; r.w = w;
        r.make_error = make_error != 0;

        int8_t* act_out = out_actions + (size_t)i * (max_record - 1);
        int32_t* agent_out = out_agent + (size_t)i * max_record * 3;
        int8_t* markers_out = out_markers + (size_t)i * max_record * cells;

        // record initial state
        agent_out[0] = r.y; agent_out[1] = r.x; agent_out[2] = r.d;
        std::memcpy(markers_out, work, cells);

        int pc = 0, n = 0, t = 1;
        bool cflag = false, fail = false, halt = false;
        int32_t ctr[MAX_LOOP_DEPTH];
        int sp = 0;
        // same safety cap as the on-device VM
        const long max_steps = (long)(MAX_FUNC_CALL + 2) * code_len;

        for (long step = 0; step < max_steps && !fail && !halt; ++step) {
            if (pc < 0 || pc >= code_len) { fail = true; break; }
            const int op = r.code[pc * 2];
            const int arg = r.code[pc * 2 + 1];
            switch (op) {
                case OP_HALT: halt = true; break;
                case OP_BUDGET:
                    n += arg;
                    if (n > MAX_FUNC_CALL) fail = true;
                    ++pc;
                    break;
                case OP_INC: n += arg; ++pc; break;
                case OP_EVAL: {
                    bool v = false;
                    switch (arg) {
                        case 0: v = clear_at(r, r.y + DY_FRONT[r.d],
                                             r.x + DX_FRONT[r.d]); break;
                        case 1: v = clear_at(r, r.y + DY_LEFT[r.d],
                                             r.x + DX_LEFT[r.d]); break;
                        case 2: v = clear_at(r, r.y + DY_RIGHT[r.d],
                                             r.x + DX_RIGHT[r.d]); break;
                        case 3: v = r.markers[r.y * w + r.x] > 0; break;
                        case 4: v = r.markers[r.y * w + r.x] <= 0; break;
                    }
                    cflag = v; ++pc;
                    break;
                }
                case OP_NEGC: cflag = !cflag; ++pc; break;
                case OP_JMP: pc = arg; break;
                case OP_JMPF: pc = cflag ? pc + 1 : arg; break;
                case OP_PUSHCTR:
                    if (sp >= MAX_LOOP_DEPTH) { fail = true; break; }
                    ctr[sp++] = arg; ++pc;
                    break;
                case OP_JZDEC:
                    if (sp <= 0) { fail = true; break; }
                    if (ctr[sp - 1] == 0) { --sp; pc = arg; }
                    else { --ctr[sp - 1]; ++pc; }
                    break;
                case OP_ACT: {
                    bool recorded = true;
                    switch (arg) {
                        case 0: {  // move
                            int ny = r.y + DY_FRONT[r.d];
                            int nx = r.x + DX_FRONT[r.d];
                            if (clear_at(r, ny, nx)) { r.y = ny; r.x = nx; }
                            else if (r.make_error) {
                                fail = true; recorded = false;
                            } else { r.d = (r.d + 2) % 4; }
                            break;
                        }
                        case 1: r.d = (r.d + 3) % 4; break;  // turnLeft
                        case 2: r.d = (r.d + 1) % 4; break;  // turnRight
                        case 3: {  // pickMarker
                            int8_t& m = r.markers[r.y * w + r.x];
                            if (m > 0) --m;
                            else if (r.make_error) {
                                fail = true; recorded = false;
                            }
                            break;
                        }
                        case 4: {  // putMarker
                            int8_t& m = r.markers[r.y * w + r.x];
                            if (m < MAX_MARKER_CAP) ++m;
                            else if (r.make_error) {
                                fail = true; recorded = false;
                            }
                            break;
                        }
                    }
                    if (recorded) {
                        if (t < max_record) {
                            act_out[t - 1] = (int8_t)arg;
                            agent_out[t * 3 + 0] = r.y;
                            agent_out[t * 3 + 1] = r.x;
                            agent_out[t * 3 + 2] = r.d;
                            std::memcpy(markers_out + (size_t)t * cells,
                                        work, cells);
                        }
                        ++t;
                    }
                    ++pc;
                    break;
                }
                default: fail = true; break;
            }
        }
        out_success[i] = (halt && !fail) ? 1 : 0;
        out_len[i] = t;
        out_n[i] = n;
    }
    delete[] work;
    return 0;
}

}  // extern "C"
