// Standalone micro-benchmark for the star-POA merge (poa_round) of the
// port's native runtime, a copy of racon_tpu/native/bench/poa_bench.cpp:
// synthetic ONT-like window-rounds (500 bp backbone, D layers, ~12% error
// op lists), timed per phase via RT_POA_PROF. Not part of the runtime's
// library. racon_tpu_torch.native.loader.build_poa_bench() builds it from
// ../src/poa.cpp and ../src/align.cpp into the gitignored ../build/, as
// the runtime is built:
//   python -m racon_tpu_torch.native.loader poa_bench
// run:  RT_POA_PROF=1 <printed path> [n_windows] [depth] [rounds]

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

#include "poa.hpp"

using namespace rt;

int main(int argc, char** argv) {
    const int n_windows = argc > 1 ? atoi(argv[1]) : 256;
    const int depth = argc > 2 ? atoi(argv[2]) : 24;
    const int rounds = argc > 3 ? atoi(argv[3]) : 3;
    const int LEN = 500;
    std::mt19937 rng(7);
    std::uniform_int_distribution<int> base(0, 3);
    std::uniform_real_distribution<double> u(0.0, 1.0);
    const char* ACGT = "ACGT";

    // distinct synthetic windows: backbone + per-layer op lists + bytes
    struct Layer {
        std::vector<uint8_t> data;
        std::vector<int32_t> w;
        std::vector<OpRun> ops;
    };
    struct Window {
        std::vector<uint8_t> backbone;
        std::vector<Layer> layers;
        std::vector<LayerView> views;
    };
    std::vector<Window> wins(n_windows);
    for (auto& W : wins) {
        W.backbone.resize(LEN);
        for (auto& b : W.backbone) b = ACGT[base(rng)];
        W.layers.resize(depth);
        for (auto& L : W.layers) {
            // walk the backbone: diag runs broken by sub/ins/del at 12%
            int t = 0;
            while (t < LEN) {
                int run = 1;
                while (t + run < LEN && u(rng) > 0.12) ++run;
                for (int x = 0; x < run; ++x) {
                    L.data.push_back(W.backbone[t + x]);
                }
                if (!L.ops.empty() && L.ops.back().op == OP_MATCH) {
                    L.ops.back().run += run;
                } else {
                    L.ops.push_back({OP_MATCH, run});
                }
                t += run;
                if (t >= LEN) break;
                const double r = u(rng);
                if (r < 0.33) {  // substitution: diag step, random base
                    L.data.push_back(ACGT[base(rng)]);
                    L.ops.back().run += 1;
                    ++t;
                } else if (r < 0.66) {  // insertion
                    L.data.push_back(ACGT[base(rng)]);
                    L.ops.push_back({OP_INS, 1});
                } else {  // deletion
                    L.ops.push_back({OP_DEL, 1});
                    ++t;
                }
            }
            L.w.assign(L.data.size(), 1);
        }
        W.views.resize(depth);
        for (int i = 0; i < depth; ++i) {
            W.views[i].data = W.layers[i].data.data();
            W.views[i].weights = W.layers[i].w.data();
            W.views[i].len = static_cast<int64_t>(W.layers[i].data.size());
            W.views[i].begin = 0;
            W.views[i].end = LEN - 1;
            W.views[i].ops = W.layers[i].ops.data();
            W.views[i].n_ops = static_cast<int64_t>(W.layers[i].ops.size());
        }
    }

    RefineParams rp;
    std::vector<uint8_t> out(4 * LEN);
    const auto t0 = std::chrono::steady_clock::now();
    for (int r = 0; r < rounds; ++r) {
        for (int wdx = 0; wdx < n_windows; ++wdx) {
            Window& W = wins[wdx];
            RoundState st;
            st.cur.assign(W.backbone.begin(), W.backbone.end());
            st.cur_w.assign(LEN, 0);
            st.cur_del.assign(LEN, -8);
            st.cur_slots.resize(LEN);
            for (int c = 0; c < LEN; ++c) st.cur_slots[c] = c;
            bool pol = false;
            poa_round(st, depth, W.views.data(), r == rounds - 1, rp, true,
                      true, -8, out.data(), out.size(), &pol, 0, wdx);
        }
    }
    const double dt = std::chrono::duration<double>(
                          std::chrono::steady_clock::now() - t0)
                          .count();
    int64_t prof[3] = {g_prof_build.load(), g_prof_bundle.load(),
                       g_prof_emit.load()};
    printf("%d windows x %d rounds x depth %d: %.3f s (%.0f w-rounds/s)\n",
           n_windows, rounds, depth, dt, n_windows * rounds / dt);
    printf("build %.1f ms  bundle %.1f ms  emit %.1f ms\n", prof[0] / 1e6,
           prof[1] / 1e6, prof[2] / 1e6);
    return 0;
}
